"""Typed configuration for the PyTorch port (L0).

A copy of the configuration families the NMPC solve and the batched
simulation need, with the same field names and defaults as
`dyobav_tpu.configs`, so the reference YAML files and the JAX package's
`to_dict()` output load unchanged.  The port
keeps its own copy rather than importing the JAX package's module.
`yaml` is imported only by the functions that read or write YAML.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List


def _load_yaml(path: str, multi_doc: bool = False) -> dict:
    import yaml

    with open(path, "r") as stream:
        if multi_doc:
            merged: dict = {}
            for doc in yaml.safe_load_all(stream):
                if doc:
                    merged.update(doc)
            return merged
        return yaml.safe_load(stream) or {}


class _YamlConfig:
    """Mixin: construct any config dataclass from a (reference-schema) YAML."""

    @classmethod
    def from_yaml(cls, yaml_path: str, with_partition: bool = False):
        raw = _load_yaml(yaml_path, multi_doc=with_partition)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in names}
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_yaml(self, yaml_path: str) -> None:
        import yaml

        with open(yaml_path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


@dataclass(frozen=True)
class WarehouseSimConfiguration(_YamlConfig):
    """Scene/simulation wiring (ref `configs.py:61-83`)."""

    scene: str = "warehouse"
    map_dir: str = "warehouse_sim_original"
    map_file: str = "mymap.pgm"
    graph_file: str = "mygraph.json"
    mmp_cfg: str = "wsd_1t20_test.yaml"
    mpc_cfg: str = "mpc_fast.yaml"
    dwa_cfg: str = "dwa_test.yaml"
    sim_width: int = 330
    sim_height: int = 293
    scale2nn: float = 1.0
    scale2real: float = 0.1
    image_axis: bool = False
    corner_coords: List[float] = field(default_factory=lambda: [-15.0, -15.0])


@dataclass(frozen=True)
class CircularRobotSpecification(_YamlConfig):
    """Physical + kinematic robot limits (ref `configs.py:86-103`)."""

    ts: float = 0.2
    vehicle_width: float = 0.5
    vehicle_margin: float = 0.2
    social_margin: float = 0.2
    lin_vel_min: float = -0.5
    lin_vel_max: float = 1.5
    lin_acc_min: float = -1.0
    lin_acc_max: float = 1.0
    ang_vel_max: float = 0.5
    ang_acc_max: float = 3.0


@dataclass(frozen=True)
class MpcConfiguration(_YamlConfig):
    """NMPC problem dimensions + penalty weights (ref `configs.py:140-176`).

    The solver-build fields of the reference (`build_directory`,
    `build_type`, `optimizer_name`) are accepted for YAML compatibility but
    unused.
    """

    ts: float = 0.2
    N_hor: int = 20
    action_steps: int = 1
    ns: int = 3
    nu: int = 2
    nq: int = 10
    Nother: int = 10
    nstcobs: int = 12
    Nstcobs: int = 10
    ndynobs: int = 6
    Ndynobs: int = 15
    max_solver_time: int = 100_000  # microseconds; solve-time budget
    build_directory: str = "mpc_solver"
    build_type: str = "release"
    bad_exit_codes: List[str] = field(
        default_factory=lambda: ["NotConvergedIterations", "NotConvergedOutOfTime"]
    )
    optimizer_name: str = "navi_fast"
    lin_vel_penalty: float = 0.0
    lin_acc_penalty: float = 10.0
    ang_vel_penalty: float = 0.0
    ang_acc_penalty: float = 20.0
    qrpd: float = 100.0
    qpos: float = 0.0
    qvel: float = 10.0
    qtheta: float = 0.0
    qpN: float = 0.0
    qthetaN: float = 0.0

    @property
    def n_params(self) -> int:
        """Length of the flat solver parameter vector (ref layout, ~2778)."""
        return (
            self.nu                                      # u_m1
            + self.ns                                    # s_0
            + self.ns                                    # s_N
            + self.nq                                    # q penalties
            + self.ns * self.N_hor                       # ref states
            + self.N_hor                                 # ref speeds
            + self.ns * self.Nother                      # other robots @ t0
            + self.ns * self.N_hor * self.Nother         # other robots predicted
            + self.Nstcobs * self.nstcobs                # static obstacles
            + self.Ndynobs * self.ndynobs * (self.N_hor + 1)  # dynamic obstacles
            + self.N_hor                                 # static obstacle weights
            + self.N_hor                                 # dynamic obstacle weights
        )


@dataclass(frozen=True)
class SolverConfiguration:
    """ALM-Newton solver knobs, field for field those of the JAX package.

    Defaults are the production operating point: the chord profile (3+2
    iterations x 3 Newton updates per exact Hessian) with the penalty
    pre-escalated to 1250, and one deep escalation stage for the lanes the
    warm profile leaves unconverged.

    dtype: a torch dtype, or None for float32.

    linear_solver: "pallas" (the default, kept so configurations carry over
    unchanged) means the port's own batched SPD Cholesky kernel
    (`ops/spd.py`, CUDA source `csrc/spd_cholesky.cu`), which computes
    what the JAX package's Pallas kernel computes.  "cholesky" is the same
    algorithm in plain PyTorch ops.  "schulz" is not ported yet and raises
    NotImplementedError (ROADMAP.md).

    hessian_mode: only "block" (the default) is ported; "structured" and
    "jacfwd" raise NotImplementedError (ROADMAP.md).
    """

    max_inner_iters: int = 3        # inner iterations in the first ALM stage
    max_outer_iters: int = 2        # ALM / penalty update stages
    inner_iters_later: int = 2      # inner iterations per warm-started stage
    initial_penalty: float = 1250.0  # pre-escalated for warm solves
    penalty_update_factor: float = 5.0
    tol: float = 1e-4               # fixed-point-residual tolerance (inner)
    constraint_tol: float = 1e-3    # ALM infeasibility tolerance
    multistart_infeas_factor: float = 10.0
    lbfgs_memory: int = 10
    dtype: Any = None               # default float32; torch dtype override
    fused: bool = True              # single-loop ALM with masked stage updates
    linear_solver: str = "pallas"   # see the class docstring
    schulz_iters: int = 14
    hessian_mode: str = "block"
    cold_profile: Any = (12, 6, 5, 1, 10.0)
                                    # (inner, outer, later, substeps[,
                                    # penalty]); its presence enables the
                                    # escalated batch path
    escalation_ladder: Any = ((6, 10, 5, 2, 10.0),)
                                    # stage profiles (inner, outer, later,
                                    # substeps[, penalty[, from_iterate]]);
                                    # None = (cold_profile, strong budget)
    escalation_residual_tol: Any = 1e-4
                                    # lanes whose residual exceeds this are
                                    # escalated even if the probe settled
    escalation_slots: Any = (16,)   # per-stage slot divisors:
                                    # K = max(B // d, min(B, 16), 1)
    newton_substeps: int = 3        # Newton updates per Hessian refresh


def strong_configuration(**overrides) -> SolverConfiguration:
    """OpEn-default solve semantics on every solve: full iteration budget,
    from-10 penalty escalation, no chord substeps."""
    base = dict(max_inner_iters=30, max_outer_iters=10, inner_iters_later=10,
                initial_penalty=10.0, newton_substeps=1, cold_profile=None)
    base.update(overrides)
    return SolverConfiguration(**base)
