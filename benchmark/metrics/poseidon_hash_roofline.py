"""poseidon_hash's share of its roofline: the bound of every call of the
window (``_counts.poseidon_hash_bound_s``) over the launches' summed device
time."""

from ._counts import kernel_seconds, poseidon_hash_bound_s


def read(ctx):
    busy = kernel_seconds(ctx.trace, "poseidon_hash")
    if busy == 0:
        return None
    c = ctx.config
    words = len(c["node_words"])
    bound = sum(
        poseidon_hash_bound_s(call["lanes"], words, c["width"], c["rate"], c["full_rounds"], c["partial_rounds"])
        for call in ctx.state["calls"]
    )
    return 100.0 * bound * ctx.trace_requests / busy
