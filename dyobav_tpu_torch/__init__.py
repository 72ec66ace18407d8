"""dyobav_tpu_torch — the PyTorch / CUDA port of `dyobav_tpu`.

A second package beside the JAX one, which stays the reference.  It mirrors
the JAX package's module paths and names so each counterpart is easy to
find, imports `torch` and numpy (never JAX, never `dyobav_tpu`), and runs
its entry points on a CUDA device unless the caller passes `device="cpu"`.

Every module of the JAX package has its counterpart (the batched NMPC
solve in every solver mode, the closed-loop batched simulation with the
constant-velocity or the SWTA neural predictor, sharded over devices and
processes, the per-episode harness with every tracker and predictor, the
PANOC method, the deployment node, the decentralized multi-robot fleet,
the SWTA / MDN training stack, and the planners):
    configs           L0  MpcConfiguration, CircularRobotSpecification,
                          SolverConfiguration, WarehouseSimConfiguration,
                          WtaNetConfiguration, DwaConfiguration
    motion.models     L1  unicycle and omnidirectional steps, MotionModel,
                          the reciprocating (back-and-forth) agent
    motion.kalman     L1  Kalman filter and its state spaces
    motion.agents     L1  Human, Robot
    utils.geometry    L1  host-side polygon geometry (numpy); point,
                          segment, ellipse and half-space primitives (torch)
    utils.density     L1  Parzen and Gaussian-mixture densities
    maps.*            L2  PGM and PNG readers, blobs, occupancy /
                          geometric maps, transforms, navigation graph (no
                          networkx, no imaging library), preset maps; the
                          two plot methods import nothing
    models.wta_net    L2  ConvMultiHypoNet (SWTA CNN), load_checkpoint
    models.heatmap    L2  heat-map input stacks
    models.mdn        L2  MDN heads and nets
    models.losses     L2  WTA meta-losses, mixture NLL
    models.data       L2  WSD dataset, DataHandler, synthetic WSD data
    models.manager    L2  NetworkManager: training loops, checkpoints
    models.train      L2  python -m dyobav_tpu_torch.models.train
    ops.params        L3  flat parameter vector <-> MpcParams
    ops.costs         L3  objective, constraints, block curvature
    ops.spd           L3  batched SPD solve (CUDA kernel csrc/spd_cholesky.cu)
    ops.spd_lanes     L3  left-looking batched SPD solve, an entry point of
                          its own (CUDA kernel csrc/spd_lanes.cu)
    ops.newton        L3  ALM Newton solver (block, structured or jacfwd
                          Hessian; fused or staged loop; Schulz solve)
    ops.panoc         L3  ALM PANOC solver (L-BFGS, FBE line search)
    ops.engine        L3  build_mpc_solver, solve_batch_escalated
    ops.dwa           L3  batched DWA grid search
    ops.cluster       L3  on-device cluster-Gaussian fit of hypotheses
    predictors.*      L4  cvmp, kfmp, mmp (ObstacleSnapper, MmpInterface)
    trackers.*        L4  MPC and DWA TrajectoryTracker
    interfaces.*      L4  map files -> map objects; MPC and DWA interfaces
    sim.harness       L5  scenario presets, MainBase (episodes, metrics)
    sim.metrics       L5  clearance, smoothness, deviation, collisions
    sim.entry         L5  python -m dyobav_tpu_torch.sim {demo,eval}
    sim.scenarios     L5  build_scenario, random_scenarios and the fleet
                          builders (synthetic, map, random)
    sim.batch         L5  build_lane_solvers, build_batch_sim,
                          make_wta_predictor, build_step_program
    sim.deploy        L5  NavigationNode on a Transport (the robot's
                          control node); sim.ros_adapter maps it onto ROS
    sim.fleet         L5  build_fleet_sim: R robots a scenario, each
                          avoiding the others' predicted trajectories
    sim.plotter       L5  the demo's live plot (matplotlib, imported lazily)
    parallel.mesh     L5  device lists, shard_batch, shard_map_batch,
                          init_distributed (torch.distributed)
    planners.*        L5  paths, Dijkstra / Yen k-shortest paths,
                          visibility graph, schedule-driven global planner
    sim.sweep         L5  python -m dyobav_tpu_torch.sim.sweep [--robots R]
                          [--devices N | --distributed]
    convert               parameters, configurations, scenarios and the
                          SWTA / MDN nets' weights (or gradients) from
                          the JAX package
"""

__version__ = "0.1.0"
