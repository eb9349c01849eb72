"""The heavy pass's share of its roofline: the least time its work could
take on the card — the larger of its operations over the float32 peak and
its bytes over the memory peak (``benchmark/counts/``, from the cell's
inputs) — over the device time the trace gives it, in per cent."""


def read(ctx):
    seconds = ctx.get("layer_s", {}).get("heavy pass")
    work = ctx.get("heavy_work")
    if not seconds or not work:
        return None
    flops, nbytes = work
    peaks = ctx["peaks"]
    least = max(flops / peaks["fp32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least * ctx["passes"] / seconds
