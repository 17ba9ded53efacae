"""Attention's share of its roofline, in %: the operations of attention
proper for each step the trace holds (the architecture's
``attention_flops``, over all of a step's attention calls, counted from
the cell's shapes; bound by operations: the bytes read and written are a
few MB against hundreds of GFLOP), over 989 TFLOP/s, divided by the device
time of the kernels launched between the end of each call's opening
module and the start of its closing one (the ``attention`` range of the
trace; the architecture's ``attention_modules``). The steps are the
range's calls over the architecture's ``attention_calls`` a step."""


def read(rec):
    tr = rec.get("trace") or {}
    secs = tr.get("range_device_s", {}).get("attention")
    calls = tr.get("range_calls", {}).get("attention")
    if not secs or not calls:
        return None
    steps = calls / rec["attention_calls"]
    return 100.0 * steps * rec["attention_flops"] / rec["peak_flops"] / secs
