"""Deployment node: the predict -> cluster -> control loop behind a message
transport, the port of `dyobav_tpu.sim.deploy`.

The shape of the reference's ROS node (`src/main_ros.py:215-412`, live on
its `ros_version` branch): subscribe robot pose + actor poses, maintain
pedestrian history buffers, run the prediction and the MPC each control
tick, publish velocity commands and diagnostics.  The node is written
against an abstract `Transport`; `sim.ros_adapter.RosTransport` maps the
four channels onto ROS topics (amcl_pose/odometry -> `robot_pose`, actor
poses -> `actor_poses`, cmd_vel <- `cmd_vel`, diagnostics <- `viz`).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np
import torch

from ..ops.engine import resolve_device, to_host
from .batch import FAR_COORD, scenario_to_device


class Transport(Protocol):
    """Minimal pub/sub surface a deployment environment must provide."""

    def subscribe(self, channel: str, callback: Callable[[dict], None]) -> None:
        ...

    def publish(self, channel: str, message: dict) -> None:
        ...


class LocalTransport:
    """In-process transport for tests and simulated deployment."""

    def __init__(self):
        self.subs: Dict[str, List[Callable]] = {}
        self.published: Dict[str, List[dict]] = collections.defaultdict(list)

    def subscribe(self, channel, callback):
        self.subs.setdefault(channel, []).append(callback)

    def publish(self, channel, message):
        self.published[channel].append(message)
        for cb in self.subs.get(channel, []):
            cb(message)


class NavigationNode:
    """Control node: wire a tracker + predictor interface, or the fused
    step program, to a transport.

    Mirrors the reference node's loop (main_ros.py:320-405): buffer actor
    histories, predict, assemble dynamic obstacles, run one MPC step,
    publish the first action as a velocity command.
    """

    def __init__(self, transport: Transport, tracker_interface=None,
                 predictor=None, ref_map=None, n_hor: int = 20,
                 history_len: int = 5, human_size: float = 0.2,
                 scale2nn: float = 1.0, fused_step=None, scenario=None,
                 n_humans: int = 1, device=None):
        """Two drive modes:

        * tracker_interface (host-orchestrated): the reference-shaped loop,
          a predictor interface and a tracker interface called per tick
          from the host.
        * fused_step + scenario: `(step, cold_start)` from
          `sim.batch.build_step_program` and the episode's `Scenario`; the
          warm start, last action and reference index stay on `device`
          (None: the current CUDA device; raises without one), and a tick
          ends with one device-to-host copy of action, cost and flag.
        """
        if tracker_interface is None and fused_step is None:
            raise ValueError("need tracker_interface or fused_step")
        self.transport = transport
        self.tracker = tracker_interface
        self.predictor = predictor
        self.ref_map = ref_map
        self.n_hor = n_hor
        self.human_size = human_size
        self.scale2nn = scale2nn
        self.robot_pose: Optional[np.ndarray] = None
        self.histories: Dict[str, collections.deque] = {}
        self.history_len = history_len
        self.fused = None
        if fused_step is not None:
            self.device = resolve_device(device)
            step, cold = fused_step
            self.fused = {
                "step": step, "cold": cold,
                "scenario": scenario_to_device(scenario, self.device),
                "n_humans": n_humans,
                "u_warm": None,
                "u_prev": torch.zeros(2, device=self.device),
                "ref_idx": torch.zeros((), dtype=torch.long,
                                       device=self.device),
            }
        transport.subscribe("robot_pose", self._on_robot_pose)
        transport.subscribe("actor_poses", self._on_actor_poses)

    def _on_robot_pose(self, msg: dict):
        self.robot_pose = np.array([msg["x"], msg["y"], msg["theta"]])

    def _on_actor_poses(self, msg: dict):
        for actor_id, (x, y) in msg["poses"].items():
            hist = self.histories.setdefault(
                actor_id, collections.deque(maxlen=self.history_len))
            hist.append([float(x), float(y)])

    def _predict_obstacles(self):
        if not self.histories:
            return None
        mu_list_list = None
        std_list_list = None
        for hist in self.histories.values():
            past = list(hist)
            positions, stds = self.predictor.get_motion_prediction(past)
            if mu_list_list is None:
                mu_list_list = [[p] for p in positions]
                std_list_list = [[s] for s in stds]
            else:
                for t, (p, s) in enumerate(zip(positions, stds)):
                    mu_list_list[t].append(p)
                    std_list_list[t].append(s)
        curr = [list(h)[-1] for h in self.histories.values()]
        mu_list_list.insert(0, curr)
        std_list_list.insert(
            0, [[self.human_size, self.human_size] for _ in curr])
        n_obs = max(len(m) for m in mu_list_list)
        dyn = [[[0, 0, 0, 0, 0, 1]] * (self.n_hor + 1) for _ in range(n_obs)]
        for t, (mus, stds) in enumerate(zip(mu_list_list, std_list_list)):
            for i, (mu, std) in enumerate(zip(mus, stds)):
                dyn[i][t] = [mu[0], mu[1], std[0], std[1], 0, 1]
        return dyn

    def _human_hist(self) -> np.ndarray:
        """(history_len, n_humans, 2) fixed-shape float32 history; missing
        actors and samples pad FAR so their obstacle slots are inert."""
        H = self.fused["n_humans"]
        out = np.full((self.history_len, H, 2), FAR_COORD, np.float32)
        for i, hist in enumerate(list(self.histories.values())[:H]):
            past = list(hist)
            if not past:
                continue
            while len(past) < self.history_len:   # backfill like the sim
                past.insert(0, past[0])
            out[:, i, :] = np.asarray(past[-self.history_len:], np.float32)
        return out

    def _fused_tick(self):
        f = self.fused
        robot = torch.as_tensor(np.asarray(self.robot_pose, np.float32),
                                device=self.device)
        hist = torch.as_tensor(self._human_hist(), device=self.device)
        if f["u_warm"] is None:                   # episode cold start
            u_init = torch.tensor([1.2, 0.0],
                                  device=self.device).repeat(self.n_hor)
            f["u_warm"] = f["cold"](f["scenario"], robot, hist, u_init)
        action, u_warm, ref_idx, ok, cost = f["step"](
            f["scenario"], robot, hist, f["u_warm"], f["u_prev"],
            f["ref_idx"])
        f["u_warm"], f["ref_idx"] = u_warm, ref_idx
        f["u_prev"] = action
        # The tick's one device-to-host copy.
        host = to_host(torch.cat([action, cost[None],
                                  ok[None].to(action.dtype)]))
        a = host[:2]
        self.transport.publish("cmd_vel", {"v": float(a[0]),
                                           "w": float(a[1])})
        self.transport.publish("viz", {"cost": float(host[2]),
                                       "converged": bool(host[3] > 0.5)})
        return a

    def control_tick(self, mode: str = "super"):
        """One control step; publishes cmd_vel and returns the action."""
        if self.robot_pose is None:
            return None
        if self.fused is not None:
            return self._fused_tick()
        self.tracker.set_current_state(self.robot_pose)
        dyn = self._predict_obstacles() if self.predictor else None
        actions, pred_states, cost, obs_list, refs = self.tracker.run_step(
            mode, dyn, map_updated=True)
        action = np.asarray(actions[0])
        if action[0] < 0:
            action = np.zeros_like(action)
        self.transport.publish("cmd_vel",
                               {"v": float(action[0]), "w": float(action[1])})
        self.transport.publish("viz", {
            "pred_states": [list(map(float, s[:2])) for s in pred_states],
            "cost": float(cost),
        })
        return action
