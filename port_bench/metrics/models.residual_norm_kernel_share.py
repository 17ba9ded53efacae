"""Share of the ViT blocks' residual updates that went through the residual
kernel, in %: the program's counters ``models.residual_norm_kernel_calls``
over that plus ``models.residual_norm_plain_calls`` (one a residual update
each, two a block). The program keeps them only while a profiler records,
so they sum over the forwards of the window's profiled part; a program
that keeps neither gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    kernel = c.get("models.residual_norm_kernel_calls", 0)
    plain = c.get("models.residual_norm_plain_calls", 0)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
