"""The card-side self time of the miners: semi-hard (``mm.mine_semihard``) and
the row-wise hard and structure miner less its PDDM rows
(``mm.mine_rowwise``) a step of the traced window, in ms."""

from perfbench import progspans


def read(run):
    return progspans.card_ms(run, "mm.mine_semihard", "mm.mine_rowwise")
