"""Share of Depth Anything 3's QK-norm / RoPE calls that went through the
kernel, in %: the program's counters ``models.qk_prep_kernel_calls`` over
that plus ``models.qk_prep_plain_calls`` (one a ``QKPrep`` call each). The
program keeps them only while a profiler records, so they sum over the
forwards of the window's profiled part; a program that keeps neither gives
none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    kernel = c.get("models.qk_prep_kernel_calls", 0)
    plain = c.get("models.qk_prep_plain_calls", 0)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
