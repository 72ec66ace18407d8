"""Graph, visibility and schedule planners (no networkx, no pandas): the
port of `dyobav_tpu.planners`."""
