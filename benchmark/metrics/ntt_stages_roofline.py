"""The NTT stage kernels' share of their roofline: the butterflies of every
transform of the window (``_counts.ntt_stages_bound_s``) over the summed
device time of ``ntt_small_stages`` and ``ntt_large_stage``.  The inverse's
n^-1 scaling runs in ``mont_mul`` and is on neither side."""

from ._counts import kernel_seconds, ntt_stages_bound_s


def read(ctx):
    busy = kernel_seconds(ctx.trace, "ntt_small_stages", "ntt_large_stage")
    if busy == 0:
        return None
    bound = sum(ntt_stages_bound_s(call["columns"], call["n"]) for call in ctx.state["calls"])
    return 100.0 * bound * ctx.trace_requests / busy
