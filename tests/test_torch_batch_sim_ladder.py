"""The port's closed loop with `multistart=False` (budget-only escalation of
the single warm guess through `engine.escalate_tail`) against the JAX
package's, on the CPU: the second of the two closed-loop comparisons of
tests/test_torch_batch_sim.py, which holds the scenarios, the stagger
stream, the budget and the checks.
"""
from test_torch_batch_sim import check_closed_loop, pytestmark  # noqa: F401


def test_closed_loop_ladder_matches_jax():
    check_closed_loop(False)
