"""The modelled work of a whole fit, per unit of work the program reports.

A GLM data pass counts as one ``value_grad`` over the rows: X read once,
whatever implements the pass. A lockstep round of G lanes counts as that
pass at G lanes (X once, each lane's vectors).
"""

from __future__ import annotations

from benchmark.yardstick import cost


def glm_pass(n_rows: int, nnz: int, n_features: int, lanes: int = 1) -> tuple[int, int]:
    """One loss-and-gradient pass of ``lanes`` vectors over one design: the
    CSR once, labels, weights and offsets once, and per lane w, the
    gradient and the two sums. At one lane it is ``cost.value_grad``."""
    words = (cost._slots(n_rows, nnz) + 3 * n_rows
             + lanes * (2 * n_features + 2))
    return 4 * nnz * lanes, cost.WORD * words

