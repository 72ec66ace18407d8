"""Live 4-panel plotter (velocity / ω / cost timeseries + map view), the
port's own copy of `dyobav_tpu.sim.plotter`.

Mirrors the reference `main_pre.Plotter` (main_pre.py:56-143).  Entirely
host-side and optional: the headless evaluation path never imports it,
and matplotlib is imported only when a plot is prepared, so a machine
without it runs everything else.
"""
from __future__ import annotations

from typing import List

import numpy as np


class Plotter:
    def __init__(self, ts: float, horizon: int):
        self.ts = ts
        self.N_hor = horizon
        self.occ_map = None

    def prepare_plots(self, occ_map, map_extent: tuple):
        import matplotlib.pyplot as plt
        from matplotlib.gridspec import GridSpec
        self.plt = plt
        self.occ_map = occ_map
        self.map_extent = map_extent
        fig = plt.figure(constrained_layout=True)
        gs = GridSpec(3, 4, figure=fig)
        self.vel_ax = fig.add_subplot(gs[0, :2])
        self.vel_ax.set_ylabel("Velocity [m/s]")
        self.omega_ax = fig.add_subplot(gs[1, :2])
        self.omega_ax.set_ylabel("Angular velocity [rad/s]")
        self.cost_ax = fig.add_subplot(gs[2, :2])
        self.cost_ax.set_xlabel("Time [s]")
        self.cost_ax.set_ylabel("Cost")
        self.map_ax = fig.add_subplot(gs[:, 2:])
        self.map_ax.set_xlabel("X [m]")
        self.map_ax.set_ylabel("Y [m]")
        self.fig = fig
        self.vel_list: List[float] = []
        self.omega_list: List[float] = []
        self.cost_list: List[float] = []

    def render_step(self, kt, base, robot, human_list, tracker_interface,
                    action, cost, pred_states, mu_list_list, std_list_list,
                    the_obs_list, others):
        plt = self.plt
        for ax in (self.vel_ax, self.omega_ax, self.cost_ax, self.map_ax):
            ax.cla()
        self.vel_list.append(float(action[0]))
        self.omega_list.append(float(action[1]))
        self.cost_list.append(float(cost))
        t = np.linspace(0, self.ts * len(self.vel_list), len(self.vel_list))
        self.vel_ax.plot([0, (kt + 1) * self.ts],
                         [tracker_interface.base_speed] * 2, "r--")
        self.vel_ax.plot(t, self.vel_list, "-o", markersize=4, color="b")
        self.omega_ax.plot(t, self.omega_list, "-o", markersize=4, color="b")
        self.cost_ax.plot(t, self.cost_list, "-o", markersize=4, color="b")

        self.map_ax.set_title(f"Time: {kt * self.ts:.2f}s / {kt:.0f}")
        self.map_ax.imshow(self.occ_map(), cmap="Greys",
                           extent=base.map_extent)

        if mu_list_list is not None:
            import matplotlib.patches as patches
            for mus, stds in zip(mu_list_list, std_list_list):
                for mu, std in zip(mus, stds):
                    self.map_ax.add_patch(patches.Ellipse(
                        mu, std[0], std[1], fc="y", ec="purple", alpha=0.2))
        if the_obs_list is not None:
            for obs in the_obs_list:
                closed = list(obs) + [obs[0]]
                arr = np.array(closed)
                self.map_ax.plot(arr[:, 0], arr[:, 1], "r-", linewidth=3)

        robot.plot_agent(self.map_ax, color="r")
        past = np.array(robot.past_traj)
        self.map_ax.plot(past[:, 0], past[:, 1], ".", color="r")
        for i, human in enumerate(human_list):
            color = ["b", "g", "c", "m", "y"][i % 5]
            human.plot_agent(self.map_ax, color=color)
            hp = np.array(human.past_traj)
            self.map_ax.plot(hp[:, 0], hp[:, 1], ".", color=color)

        ref = np.array(tracker_interface.ref_path)
        self.map_ax.plot(ref[:, 0], ref[:, 1], "rx")
        if pred_states is not None:
            ps = np.array(pred_states)
            self.map_ax.plot(ps[:, 0], ps[:, 1], "m.")

        # Tracker-specific overlays (reference plot_references_mpc/_dwa,
        # main_pre.py:128-143): MPC shows the resampled reference
        # trajectory and the current N_hor reference window; DWA shows the
        # sampled candidate trajectories with per-candidate costs.
        if others:
            if len(others) == 1:               # MPC: [current_refs]
                ref_traj = getattr(tracker_interface, "ref_traj", None)
                if ref_traj is not None and len(ref_traj):
                    rt = np.array([s[:2] for s in ref_traj])
                    self.map_ax.plot(rt[:, 0], rt[:, 1], "r--")
                cur = np.asarray(others[0])
                if cur.size:
                    self.map_ax.plot(cur[:, 0], cur[:, 1], "gx")
            elif len(others) == 3:             # DWA: [all, ok, ok_cost]
                all_traj, ok_traj, ok_cost = others
                for tr in all_traj:
                    tr = np.asarray(tr)
                    self.map_ax.plot(tr[:, 0], tr[:, 1], "c-", linewidth=1)
                for tr, c in zip(ok_traj, ok_cost):
                    tr = np.asarray(tr)
                    self.map_ax.plot(tr[:, 0], tr[:, 1], "m-", linewidth=1)
                    self.map_ax.text(tr[-1][0], tr[-1][1], f"{round(float(c), 2)}",
                                     fontsize=8, color="m")
        plt.draw()
        plt.pause(0.01)

    def show(self):
        self.plt.show()
