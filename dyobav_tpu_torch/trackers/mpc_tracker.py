"""MPC trajectory tracker: the part of `dyobav_tpu.trackers.mpc_tracker` the
scenario constructors need.

Only the static `TrajectoryTracker.get_ref_traj` is ported: the
constant-speed resampling of a waypoint path that
`sim.scenarios.build_scenario` turns into the reference trajectory.  The
stateful receding-horizon loop (construction, `run_step`, the per-step
multistart) is not ported yet and raises NotImplementedError (ROADMAP.md,
queue A item 8); in the batched simulation its decision rule runs as
`sim.batch.build_lane_solvers`' `solve_batch_multistart`.
"""
from __future__ import annotations

import math
from typing import List

_NOT_PORTED = ("the stateful TrajectoryTracker is not ported yet; only the "
               "static get_ref_traj is (ROADMAP.md, queue A item 8)")


class TrajectoryTracker:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    @staticmethod
    def get_ref_traj(ts: float, ref_path: List[tuple], state, speed: float) -> List[tuple]:
        """Constant-speed resampling of the waypoint path into a trajectory
        (trajectory_tracker.py:202-240)."""
        x, y = float(state[0]), float(state[1])
        path = [(float(p[0]), float(p[1])) for p in ref_path]
        path_idx = 0
        x_next, y_next = path[0]
        ref_traj: List[tuple] = []
        x_dir = y_dir = 0.0
        traveling = True
        while traveling:
            # Inner stepping loop.  Reference quirk preserved
            # (trajectory_tracker.py:215-237): on reaching a waypoint
            # mid-step the elapsed time is NOT carried over — the walker
            # re-enters the loop with a fresh full ts toward the next node,
            # so points near node crossings advance slightly farther.
            while True:
                dist = math.hypot(x_next - x, y_next - y)
                if dist < 1e-9:
                    path_idx += 1
                    if path_idx > len(path) - 1:
                        traveling = False
                    else:
                        x_next, y_next = path[path_idx]
                    break
                x_dir, y_dir = (x_next - x) / dist, (y_next - y) / dist
                eta = dist / speed
                if eta > ts:
                    x += x_dir * speed * ts
                    y += y_dir * speed * ts
                    break
                x += x_dir * speed * eta
                y += y_dir * speed * eta
                path_idx += 1
                if path_idx > len(path) - 1:
                    traveling = False
                    break
                x_next, y_next = path[path_idx]
            if not dist < 1e-9:
                ref_traj.append((x, y, math.atan2(y_dir, x_dir)))
        return ref_traj

    @staticmethod
    def get_ref_states(*args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)
