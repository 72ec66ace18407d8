"""dyobav_tpu_torch — the PyTorch / CUDA port of `dyobav_tpu`.

A second package beside the JAX one, which stays the reference.  It mirrors
the JAX package's module paths and names so each counterpart is easy to
find, imports `torch` and numpy (never JAX, never `dyobav_tpu`), and runs
its entry points on a CUDA device unless the caller passes `device="cpu"`.

Ported so far (the batched NMPC solve and the closed-loop batched
simulation with the constant-velocity or the SWTA neural predictor):
    configs           L0  MpcConfiguration, CircularRobotSpecification,
                          SolverConfiguration, WarehouseSimConfiguration,
                          WtaNetConfiguration
    motion.models     L1  unicycle RK4 step
    utils.geometry    L1  host-side polygon geometry (numpy)
    maps.*            L2  PGM and PNG readers, blobs, occupancy /
                          geometric maps, transforms, navigation graph (no
                          networkx, no imaging library)
    models.wta_net    L2  ConvMultiHypoNet (SWTA CNN), load_checkpoint
    models.heatmap    L2  heat-map input stacks
    ops.params        L3  flat parameter vector <-> MpcParams
    ops.costs         L3  objective, constraints, block curvature
    ops.spd           L3  batched SPD solve (CUDA kernel csrc/spd_cholesky.cu)
    ops.spd_lanes     L3  left-looking batched SPD solve, an entry point of
                          its own (CUDA kernel csrc/spd_lanes.cu)
    ops.newton        L3  ALM Newton solver (block Hessian, fused loop)
    ops.engine        L3  build_mpc_solver, solve_batch_escalated
    ops.cluster       L3  on-device cluster-Gaussian fit of hypotheses
    predictors.mmp    L4  ObstacleSnapper, MmpInterface
    trackers.mpc_tracker  TrajectoryTracker.get_ref_traj only
    interfaces.map_interface  L4  map files -> map objects
    sim.harness       L5  scenario presets, MainBase map loading,
                          ref_map
    sim.scenarios     L5  build_scenario, random_scenarios
    sim.batch         L5  build_lane_solvers, build_batch_sim,
                          make_wta_predictor
    sim.sweep         L5  python -m dyobav_tpu_torch.sim.sweep
    convert               parameters, configurations, scenarios and the
                          SWTA net's weights from the JAX package
"""

__version__ = "0.1.0"
