"""The paper's closed-form linear + quadratic-loss case (§3, Fig. 2).

Model (Eqs. 7-8): H_m(x) = b_m x + a_m (client m), G(s) = w s + d (server),
loss L = (F_m(x) - y)². Data for task m: x ~ N(0, sigma_m²) with targets
generated by ground-truth (b*_m, a*_m, w*, d*). Expected loss and its exact
gradients are polynomial in the first/second moments, so full-batch GD is
simulable without sampling — exactly what Fig. 2 plots.

The Lipschitz constants (Eqs. 9-10) computed here drive lr_policy.

A copy of `repro.core.theory` (numpy only), so the port loads without jax.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class LinearMTSL:
    """Exact expected-loss GD for the 2-layer linear MTSL system."""

    second_moments: np.ndarray  # E[X_m^2], shape [M]
    b_star: np.ndarray
    a_star: np.ndarray
    w_star: float
    d_star: float

    def __post_init__(self):
        self.M = len(self.second_moments)

    # expected per-task loss: E[(w(b x + a) + d - (w*(b* x + a*) + d*))^2]
    # with x ~ N(0, s2): E[(A x + B)^2] = A^2 s2 + B^2 where
    # A = w b - w* b*, B = w a + d - (w* a* + d*)
    def task_loss(self, params, m: int) -> float:
        w, d, b, a = params["w"], params["d"], params["b"][m], params["a"][m]
        A = w * b - self.w_star * self.b_star[m]
        B = w * a + d - (self.w_star * self.a_star[m] + self.d_star)
        return float(A**2 * self.second_moments[m] + B**2)

    def total_loss(self, params) -> float:
        return sum(self.task_loss(params, m) for m in range(self.M))

    def grads(self, params):
        w, d = params["w"], params["d"]
        gb = np.zeros(self.M)
        ga = np.zeros(self.M)
        gw = 0.0
        gd = 0.0
        for m in range(self.M):
            s2 = self.second_moments[m]
            A = w * params["b"][m] - self.w_star * self.b_star[m]
            B = w * params["a"][m] + d - (self.w_star * self.a_star[m] + self.d_star)
            gb[m] = 2 * A * s2 * w
            ga[m] = 2 * B * w
            gw += 2 * A * s2 * params["b"][m] + 2 * B * params["a"][m]
            gd += 2 * B
        return {"w": gw, "d": gd, "b": gb, "a": ga}

    def lipschitz(self, params):
        """Paper Eqs. 9-10 at the current parameters."""
        L_s = max(
            2.0 * self.M,
            2.0 * float(np.sum(params["b"] ** 2 * self.second_moments + params["a"] ** 2)),
        )
        L_i = np.maximum(2.0 * params["w"] ** 2, 2.0 * params["w"] ** 2 * self.second_moments)
        return L_s, L_i

    def run_gd(self, params0, eta_server: float, eta_clients: Sequence[float],
               steps: int, adaptive: bool = False):
        """Per-component GD (Alg. 1 in the linear case). Returns the per-task
        loss trajectories [steps+1, M].

        adaptive=True treats eta_* as *safety factors* on the paper's 1/L
        rule (Eqs. 9-10) recomputed at the current iterate — the objective is
        bilinear, so L is parameter-dependent and a fixed step can diverge.
        """
        p = {
            "w": float(params0["w"]),
            "d": float(params0["d"]),
            "b": np.array(params0["b"], float).copy(),
            "a": np.array(params0["a"], float).copy(),
        }
        eta_c = np.asarray(eta_clients, float)
        traj = [[self.task_loss(p, m) for m in range(self.M)]]
        for _ in range(steps):
            g = self.grads(p)
            if adaptive:
                L_s, L_i = self.lipschitz(p)
                es = eta_server / L_s
                ec = eta_c / L_i
            else:
                es, ec = eta_server, eta_c
            p["w"] -= es * g["w"]
            p["d"] -= es * g["d"]
            p["b"] -= ec * g["b"]
            p["a"] -= ec * g["a"]
            traj.append([self.task_loss(p, m) for m in range(self.M)])
        return np.asarray(traj)

    def run_separate(self, params0, eta: float, steps: int):
        """Paper Fig. 2a control: an independent (w_m, d_m) server per task —
        no shared server, i.e. M disjoint linear models."""
        M = self.M
        p = {
            "w": np.full(M, float(params0["w"])),
            "d": np.full(M, float(params0["d"])),
            "b": np.array(params0["b"], float).copy(),
            "a": np.array(params0["a"], float).copy(),
        }
        traj = []

        def losses():
            out = []
            for m in range(M):
                A = p["w"][m] * p["b"][m] - self.w_star * self.b_star[m]
                B = p["w"][m] * p["a"][m] + p["d"][m] - (
                    self.w_star * self.a_star[m] + self.d_star
                )
                out.append(A**2 * self.second_moments[m] + B**2)
            return out

        traj.append(losses())
        for _ in range(steps):
            for m in range(M):
                s2 = self.second_moments[m]
                A = p["w"][m] * p["b"][m] - self.w_star * self.b_star[m]
                B = p["w"][m] * p["a"][m] + p["d"][m] - (
                    self.w_star * self.a_star[m] + self.d_star
                )
                gw = 2 * A * s2 * p["b"][m] + 2 * B * p["a"][m]
                gd = 2 * B
                gb = 2 * A * s2 * p["w"][m]
                ga = 2 * B * p["w"][m]
                p["w"][m] -= eta * gw
                p["d"][m] -= eta * gd
                p["b"][m] -= eta * gb
                p["a"][m] -= eta * ga
            traj.append(losses())
        return np.asarray(traj)


def paper_fig2_setup(moment_ratio: float = 10.0) -> LinearMTSL:
    """Two clients; client 2 has a 10x second moment (paper Fig. 2)."""
    return LinearMTSL(
        second_moments=np.array([1.0, moment_ratio]),
        b_star=np.array([1.5, -0.7]),
        a_star=np.array([0.3, 0.9]),
        w_star=1.2,
        d_star=-0.4,
    )
