"""Online physics-parameter estimation from recorded interactions
(counterpart of ``adaptigraph_tpu/planning/physics_optimizer.py``).

Each generation of candidate parameters is evaluated in one batched call:
``dynamics_error_population`` flattens (candidates x interactions) into one
``dynamics_masked`` batch: on CUDA one rollout-kernel launch for edge policy
``none``, one single-step-forward launch per substep for a tool policy. The
search itself is host-side numpy: CMA-ES for multi-dimensional parameters, a
GP surrogate with expected-improvement proposals for one-dimensional ones
(own copies of the JAX package's numpy classes).
"""

import dataclasses
import glob
import os

import numpy as np
import torch

from adaptigraph_tpu_torch.ops.costs import masked_chamfer
from adaptigraph_tpu_torch.planning.forward import DynamicsConfig, dynamics_masked

PARAM_LO, PARAM_HI = -0.2, 1.2


# ---------------------------------------------------------------------------
# batched error evaluation (the device-side core)
# ---------------------------------------------------------------------------

def dynamics_error_population(params, interactions, candidates, cfg: DynamicsConfig,
                              device="cuda", compute_dtype=torch.bfloat16):
    """Mean masked-Chamfer dynamics error of each candidate physics parameter
    over all recorded interactions.

    interactions: dict of arrays state_init (I, max_nobj, 3), init_mask
    (I, max_nobj) bool, state_real (I, max_nobj, 3), real_mask (I, max_nobj)
    bool, act (I, 4), and optionally valid (I,) (padding rows are False).
    candidates: (P, phys_dim). Returns a (P,) tensor on ``device``.
    """
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    cand = t(np.atleast_2d(np.asarray(candidates, np.float32)))
    P = cand.shape[0]
    s0, m0 = t(interactions["state_init"]), t(interactions["init_mask"], torch.bool)
    sr, mr = t(interactions["state_real"]), t(interactions["real_mask"], torch.bool)
    act = t(interactions["act"])
    I = act.shape[0]

    def tile(x):  # (I, ...) -> (P*I, ...), candidate-major
        return x[None].expand(P, *x.shape).reshape(P * I, *x.shape[1:])

    phys = torch.repeat_interleave(cand, I, dim=0)
    pred = dynamics_masked(params, tile(s0), tile(m0), tile(act), phys, cfg,
                           compute_dtype=compute_dtype)
    err = masked_chamfer(pred, tile(sr), tile(m0), tile(mr)).reshape(P, I)
    valid = interactions.get("valid")
    if valid is None:
        return err.mean(dim=1)
    v = t(valid)
    return (err * v[None, :]).sum(dim=1) / torch.clamp(v.sum(), min=1.0)


# ---------------------------------------------------------------------------
# CMA-ES (multi-dimensional params)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CMAState:
    mean: np.ndarray
    sigma: float
    C: np.ndarray
    p_sigma: np.ndarray
    p_c: np.ndarray
    gen: int = 0


class CMAES:
    """Minimal (mu/mu_w, lambda)-CMA-ES (Hansen's standard update equations)
    with box projection; ask() returns the whole generation for one batched
    device evaluation."""

    def __init__(self, x0, sigma0=0.2, popsize=None, lo=PARAM_LO, hi=PARAM_HI, seed=0):
        x0 = np.asarray(x0, np.float64)
        self.n = len(x0)
        self.lam = popsize or 4 + int(3 * np.log(self.n))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / np.sum(self.w**2)
        n, mu_eff = self.n, self.mu_eff
        self.c_sigma = (mu_eff + 2) / (n + mu_eff + 5)
        self.d_sigma = 1 + 2 * max(0.0, np.sqrt((mu_eff - 1) / (n + 1)) - 1) + self.c_sigma
        self.c_c = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
        self.c_1 = 2 / ((n + 1.3) ** 2 + mu_eff)
        self.c_mu = min(1 - self.c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))
        self.lo, self.hi = lo, hi
        self.rng = np.random.RandomState(seed)
        self.s = CMAState(mean=x0.copy(), sigma=float(sigma0), C=np.eye(n),
                          p_sigma=np.zeros(n), p_c=np.zeros(n))
        self.best_x, self.best_f = x0.copy(), np.inf

    def ask(self):
        s = self.s
        eigvals, B = np.linalg.eigh(s.C)
        eigvals = np.maximum(eigvals, 1e-14)
        self._B, self._D = B, np.sqrt(eigvals)
        z = self.rng.randn(self.lam, self.n)
        y = z @ (B * self._D).T  # y_k = B D z_k
        x = s.mean + s.sigma * y
        self._y = y
        return np.clip(x, self.lo, self.hi)

    def tell(self, x, f):
        s, n = self.s, self.n
        f = np.asarray(f, np.float64)
        order = np.argsort(f)
        if f[order[0]] < self.best_f:
            self.best_f = float(f[order[0]])
            self.best_x = x[order[0]].copy()
        y_sel = self._y[order[: self.mu]]
        y_w = self.w @ y_sel
        s.mean = np.clip(s.mean + s.sigma * y_w, self.lo, self.hi)

        # step-size path (C^{-1/2} y = B D^{-1} B^T y)
        c_inv_sqrt_y = self._B @ ((self._B.T @ y_w) / self._D)
        s.p_sigma = (1 - self.c_sigma) * s.p_sigma + np.sqrt(
            self.c_sigma * (2 - self.c_sigma) * self.mu_eff) * c_inv_sqrt_y
        s.sigma *= np.exp((self.c_sigma / self.d_sigma) *
                          (np.linalg.norm(s.p_sigma) / self.chi_n - 1))

        h_sigma = float(np.linalg.norm(s.p_sigma) /
                        np.sqrt(1 - (1 - self.c_sigma) ** (2 * (s.gen + 1)))
                        < (1.4 + 2 / (n + 1)) * self.chi_n)
        s.p_c = (1 - self.c_c) * s.p_c + h_sigma * np.sqrt(
            self.c_c * (2 - self.c_c) * self.mu_eff) * y_w
        rank_mu = (y_sel * self.w[:, None]).T @ y_sel
        s.C = ((1 - self.c_1 - self.c_mu) * s.C
               + self.c_1 * (np.outer(s.p_c, s.p_c)
                             + (1 - h_sigma) * self.c_c * (2 - self.c_c) * s.C)
               + self.c_mu * rank_mu)
        s.C = (s.C + s.C.T) / 2
        s.gen += 1


# ---------------------------------------------------------------------------
# GP surrogate search (1-D params)
# ---------------------------------------------------------------------------

def _matern52(d2, length):
    d = np.sqrt(np.maximum(d2, 0.0)) / length
    s5 = np.sqrt(5.0)
    return (1 + s5 * d + 5.0 / 3.0 * d * d) * np.exp(-s5 * d)


class GPOptimizer1D:
    """GP(Matern-5/2 + white) minimizer on [lo, hi] with batched EI proposals.

    Mirrors the reference's gp_minimize configuration
    (physics_param_optimizer.py:93-105): n_initial random points, EI
    acquisition, final answer = posterior-mean minimizer. Length-scale and
    noise are fit by log-marginal-likelihood over a small grid (in place of
    skopt's n_restarts_optimizer); the acquisition is maximized exactly on a
    dense grid, and each round proposes ``batch`` points via constant-liar
    q-EI so the expensive evaluations stay batched on device.
    """

    def __init__(self, lo=PARAM_LO, hi=PARAM_HI, n_grid=513, seed=42):
        self.lo, self.hi = lo, hi
        self.grid = np.linspace(lo, hi, n_grid)
        self.rng = np.random.RandomState(seed)
        self.X = np.empty(0)
        self.Y = np.empty(0)

    def add(self, x, y):
        self.X = np.concatenate([self.X, np.ravel(x)])
        self.Y = np.concatenate([self.Y, np.ravel(y)])

    def _fit(self):
        X, Y = self.X, self.Y
        ymu, ystd = Y.mean(), max(Y.std(), 1e-9)
        Yn = (Y - ymu) / ystd
        d2 = (X[:, None] - X[None, :]) ** 2
        best = None
        for ls in (0.05, 0.1, 0.2, 0.4, 0.8, 1.4):
            for noise in (1e-6, 1e-4, 1e-2, 4e-2):
                K = _matern52(d2, ls) + noise * np.eye(len(X))
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, Yn))
                lml = (-0.5 * Yn @ alpha - np.log(np.diag(L)).sum())
                if best is None or lml > best[0]:
                    best = (lml, ls, noise, L, alpha)
        _, ls, noise, L, alpha = best
        self._post = (ls, L, alpha, ymu, ystd)

    def _predict(self, xs):
        ls, L, alpha, ymu, ystd = self._post
        ks = _matern52((xs[:, None] - self.X[None, :]) ** 2, ls)
        mu = ks @ alpha
        v = np.linalg.solve(L, ks.T)
        var = np.maximum(_matern52(np.zeros(len(xs)), ls) - np.sum(v * v, axis=0), 1e-12)
        return mu * ystd + ymu, np.sqrt(var) * ystd

    def propose(self, batch):
        """Batch of candidates: EI on the grid with constant-liar updates."""
        self._fit()
        X_save, Y_save = self.X.copy(), self.Y.copy()
        out = []
        for _ in range(batch):
            mu, sd = self._predict(self.grid)
            fbest = self.Y.min()
            z = (fbest - mu) / sd
            from scipy.stats import norm  # scipy ships with the image
            ei = (fbest - mu) * norm.cdf(z) + sd * norm.pdf(z)
            x = self.grid[int(np.argmax(ei))]
            out.append(x)
            self.add(x, fbest)  # constant liar
            self._fit()
        self.X, self.Y = X_save, Y_save
        self._fit()
        return np.asarray(out)

    def posterior_min(self):
        self._fit()
        mu, _ = self._predict(self.grid)
        i = int(np.argmin(mu))
        return float(self.grid[i]), float(mu[i])


# ---------------------------------------------------------------------------
# the online optimizer
# ---------------------------------------------------------------------------

class PhysicsParamOnlineOptimizer:
    """Holds the current physics-parameter estimate and refines it from all
    recorded interactions (``interaction_{i:03d}.npz`` files with keys
    act/state_init/state_pred/state_real, or ``add_interaction``).

    ``model_params`` is the nested parameter dict on ``device``.
    """

    def __init__(self, cfg: DynamicsConfig, model_params, phys_dim=1, save_dir=None, seed=0,
                 pad_i=16, pad_p=32, device="cuda", compute_dtype=torch.bfloat16):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PhysicsParamOnlineOptimizer: device='cuda' but no CUDA "
                               "device is available")
        self.cfg = cfg
        self.params = model_params
        self.compute_dtype = compute_dtype
        self.phys_dim = phys_dim
        self.save_dir = save_dir
        self.seed = seed
        self.pad_i = pad_i  # interaction-axis pad quantum (see evaluate)
        self.pad_p = pad_p  # population-axis pad quantum
        self.physics_param = np.full(phys_dim, 0.5, np.float32)
        self._interactions = []

    # -- interaction recording ------------------------------------------------
    def add_interaction(self, act, state_init, state_pred, state_real):
        max_nobj = self.cfg.gnn.max_nobj

        def padm(s):
            s = np.asarray(s, np.float32)
            m = np.zeros(max_nobj, bool)
            m[: s.shape[0]] = True
            return np.pad(s, ((0, max_nobj - s.shape[0]), (0, 0))), m

        si, mi = padm(state_init)
        sr, mr = padm(state_real)
        rec = dict(act=np.asarray(act, np.float32), state_init=si, init_mask=mi,
                   state_real=sr, real_mask=mr,
                   state_pred=np.asarray(state_pred, np.float32))
        self._interactions.append(rec)
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            i = len(self._interactions) - 1
            np.savez(os.path.join(self.save_dir, f"interaction_{i:03d}.npz"),
                     act=rec["act"], state_init=np.asarray(state_init, np.float32),
                     state_pred=rec["state_pred"],
                     state_real=np.asarray(state_real, np.float32))

    def load_interactions(self, load_dir):
        for f in sorted(glob.glob(os.path.join(load_dir, "interaction_*.npz"))):
            with np.load(f) as r:
                self.add_interaction(r["act"], r["state_init"], r["state_pred"],
                                     r["state_real"])

    def _stacked(self):
        ks = ("act", "state_init", "init_mask", "state_real", "real_mask")
        return {k: np.stack([r[k] for r in self._interactions]) for k in ks}

    def evaluate(self, candidates):
        """(P, phys_dim) candidates -> (P,) numpy errors, one device call.

        Both batch axes are padded by repeating real rows (interactions to a
        multiple of ``pad_i``, the population to a multiple of ``pad_p``) so
        every call has one of few batch sizes; padded interactions are left
        out of the mean."""
        inter = self._stacked()
        cand = np.atleast_2d(np.asarray(candidates, np.float32))
        if cand.shape[-1] != self.phys_dim:  # 1-D candidates passed flat
            cand = cand.reshape(-1, self.phys_dim)
        I, P = inter["act"].shape[0], cand.shape[0]
        Ipad = -(-I // self.pad_i) * self.pad_i
        Ppad = -(-P // self.pad_p) * self.pad_p
        if Ipad != I:
            reps = np.arange(Ipad) % I
            inter = {k: v[reps] for k, v in inter.items()}
        inter["valid"] = (np.arange(Ipad) < I)
        if Ppad != P:
            cand = cand[np.arange(Ppad) % P]
        err = dynamics_error_population(self.params, inter, cand, self.cfg, self.device,
                                        self.compute_dtype)
        return err.cpu().numpy()[:P]

    # -- optimization ---------------------------------------------------------
    def optimize(self, i=None, iterations=50):
        """Refine the estimate from all recorded interactions. ``iterations``
        is the total evaluation budget."""
        if not self._interactions:
            raise RuntimeError("no interactions recorded")
        init_error = float(self.evaluate(self.physics_param[None])[0])
        if self.phys_dim == 1:
            est, err = self._optimize_gp(iterations)
        else:
            est, err = self._optimize_cma(iterations)
        self.physics_param = np.clip(est, PARAM_LO, PARAM_HI).astype(np.float32)
        if self.save_dir and i is not None:
            np.savez(os.path.join(self.save_dir, f"ppo_{i}.npz"),
                     physics_param=self.physics_param, error=err,
                     error_init=init_error)
        return self.physics_param, err, init_error

    def _optimize_gp(self, budget, batch=10):
        gp = GPOptimizer1D(seed=42)
        n_init = min(20, max(budget // 2, 2))
        x0 = np.concatenate([[float(self.physics_param[0])],
                             gp.rng.uniform(PARAM_LO, PARAM_HI, n_init - 1)])
        gp.add(x0, self.evaluate(x0[:, None]))
        spent = n_init
        while spent < budget:
            b = min(batch, budget - spent)
            xs = gp.propose(b)
            gp.add(xs, self.evaluate(xs[:, None]))
            spent += b
        x, _ = gp.posterior_min()
        err = float(self.evaluate(np.asarray([[x]]))[0])
        return np.asarray([x], np.float32), err

    def _optimize_cma(self, budget):
        es = CMAES(self.physics_param, sigma0=0.2, seed=self.seed)
        spent = 0
        while spent < budget:
            xs = es.ask()
            es.tell(xs, self.evaluate(xs))
            spent += es.lam
        err = float(self.evaluate(es.best_x[None])[0])
        return es.best_x.astype(np.float32), err
