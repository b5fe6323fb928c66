"""The share of the fused step's mined triplets that fired, in percent:
100 x (semi-hard + hard + structure triplets that fired) over the
triplets every miner is padded to, counted by the program in the traced
window (``mm.semihard_fired``, ``mm.hard_fired``, ``mm.struct_fired``,
``mm.triplet_budget``).  The step forwards and backpropagates the padded
rows whatever fires."""

from perfbench import progspans


def read(run):
    return progspans.counted_share(
        run, ("mm.semihard_fired", "mm.hard_fired", "mm.struct_fired"),
        "mm.triplet_budget")
