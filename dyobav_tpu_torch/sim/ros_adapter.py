"""ROS transport adapter for the deployment node, the port's own copy of
`dyobav_tpu.sim.ros_adapter` (framework-free).

Maps `NavigationNode`'s four abstract channels onto ROS Noetic topics, the
way the reference's ROS node wires them (`src/main_ros.py:160-212`, live on
its `ros_version` branch):

  robot_pose  <- /amcl_pose (PoseWithCovarianceStamped, estimated=True)
                 or /base_pose_ground_truth (Odometry)
  actor_poses <- /actor{i}_pose (Odometry) per tracked pedestrian
  cmd_vel     -> /mobile_base_controller/cmd_vel (Twist)
  viz         -> /dyobav/pred_states (Path-like dict as a JSON String)

rospy is not installed in this environment, so everything ROS-specific is
behind the `RosTransport` constructor; the pure message conversions
(`quaternion_yaw`, `odometry_to_pose`) are module-level and unit-testable
without ROS.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, List


def quaternion_yaw(qx: float, qy: float, qz: float, qw: float) -> float:
    """Yaw (rotation about z) of a quaternion — the transformations.
    euler_from_quaternion(...)[-1] the reference relies on, without tf."""
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return math.atan2(siny_cosp, cosy_cosp)


def odometry_to_pose(msg) -> dict:
    """Odometry / PoseWithCovarianceStamped -> {'x','y','theta'} channel
    message (main_ros.py:147-177 shape)."""
    pose = msg.pose.pose
    q = pose.orientation
    return {"x": float(pose.position.x), "y": float(pose.position.y),
            "theta": quaternion_yaw(q.x, q.y, q.z, q.w)}


class RosTransport:
    """`deploy.Transport` implementation over rospy topics.

    Parameters
    ----------
    n_actors : number of `/actor{i}_pose` Odometry topics to merge into the
        single `actor_poses` channel (the reference hardcodes actor1,
        main_ros.py:205-212).
    estimated_pose : subscribe /amcl_pose instead of ground-truth odometry.
    """

    CMD_VEL_TOPIC = "/mobile_base_controller/cmd_vel"

    def __init__(self, n_actors: int = 1, estimated_pose: bool = False,
                 node_name: str = "dyobav_tpu_nav"):
        import rospy  # deferred: only needed on a real robot
        from geometry_msgs.msg import PoseWithCovarianceStamped, Twist
        from nav_msgs.msg import Odometry
        from std_msgs.msg import String

        self._rospy = rospy
        self._Twist = Twist
        rospy.init_node(node_name, anonymous=False)

        self._subs: Dict[str, List[Callable[[dict], None]]] = {}
        self._cmd_pub = rospy.Publisher(self.CMD_VEL_TOPIC, Twist,
                                        queue_size=1)
        self._viz_pub = rospy.Publisher("/dyobav/pred_states", String,
                                        queue_size=1)

        if estimated_pose:
            rospy.Subscriber("/amcl_pose", PoseWithCovarianceStamped,
                             self._on_robot_pose)
        else:
            rospy.Subscriber("/base_pose_ground_truth", Odometry,
                             self._on_robot_pose)
        self._actor_poses: Dict[str, tuple] = {}
        for i in range(1, n_actors + 1):
            rospy.Subscriber(f"/actor{i}_pose", Odometry,
                             self._make_actor_cb(f"actor{i}"))

    # -- channel side (deploy.Transport protocol) -------------------------
    def subscribe(self, channel: str, callback: Callable[[dict], None]):
        self._subs.setdefault(channel, []).append(callback)

    def publish(self, channel: str, message: dict):
        if channel == "cmd_vel":
            cmd = self._Twist()
            cmd.linear.x = message["v"]
            cmd.angular.z = message["w"]
            self._cmd_pub.publish(cmd)
        elif channel == "viz":
            from std_msgs.msg import String
            self._viz_pub.publish(String(data=json.dumps(message)))
        else:
            # Publishes to unknown channels are wiring bugs; surface them
            # instead of silently dropping the message.
            self._rospy.logwarn(
                f"RosTransport: publish to unknown channel '{channel}' "
                "(expected 'cmd_vel' or 'viz') — dropped")

    # -- ROS side ----------------------------------------------------------
    def _dispatch(self, channel: str, message: dict):
        for cb in self._subs.get(channel, []):
            cb(message)

    def _on_robot_pose(self, msg):
        self._dispatch("robot_pose", odometry_to_pose(msg))

    def _make_actor_cb(self, actor_id: str):
        def cb(msg):
            p = odometry_to_pose(msg)
            self._actor_poses[actor_id] = (p["x"], p["y"])
            self._dispatch("actor_poses", {"poses": dict(self._actor_poses)})
        return cb

    def spin(self, node, ts: float, mode: str = "super"):
        """Run `node.control_tick(mode)` every `ts` seconds until shutdown
        (the reference's rate-loop, main_ros.py:379-405)."""
        if not ts > 0:
            raise ValueError(f"spin() needs a positive control period, got ts={ts}")
        rate = self._rospy.Rate(1.0 / ts)
        while not self._rospy.is_shutdown():
            node.control_tick(mode)
            rate.sleep()
