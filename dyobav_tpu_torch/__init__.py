"""dyobav_tpu_torch — the PyTorch / CUDA port of `dyobav_tpu`.

A second package beside the JAX one, which stays the reference.  It mirrors
the JAX package's module paths and names so each counterpart is easy to
find, imports `torch` and numpy (never JAX, never `dyobav_tpu`), and runs
its entry points on a CUDA device unless the caller passes `device="cpu"`.

Ported so far (the batched NMPC solve):
    configs           L0  MpcConfiguration, CircularRobotSpecification,
                          SolverConfiguration
    motion.models     L1  unicycle RK4 step
    ops.params        L3  flat parameter vector <-> MpcParams
    ops.costs         L3  objective, constraints, block curvature
    ops.spd           L3  batched SPD solve (CUDA kernel csrc/spd_cholesky.cu)
    ops.newton        L3  ALM Newton solver (block Hessian, fused loop)
    ops.engine        L3  build_mpc_solver, solve_batch_escalated
    convert               parameters and configurations from the JAX package
"""

__version__ = "0.1.0"
