"""Hyperparameter sweep — the `yolo/test.py` + Ax equivalent (port of
the JAX package's ``sweep.py``).

The reference wires hydra's Ax sweeper + joblib launcher to a single-epoch
objective returning mAP or -val_loss (`yolo/test.py:19-78`,
`hydra/hyperopt.yaml`, `hydra/hp_optim/opt1.yaml`). Here:

* the search space comes from ``configs/hp_optim/opt1.yaml`` (same
  parameters and bounds);
* candidates are drawn by scrambled-Sobol quasi-random search with a
  GP-EI proposer (or incumbent perturbation) after the Sobol phase; numpy
  and scipy, the JAX package's draws exactly;
* each trial runs the shared 1-epoch objective (the port's ``main.py``)
  in-process, or, with ``workers`` > 1, in spawned processes on the
  parent's device (several processes can share one GPU);
* failed/non-finite trials score -1e7 exactly like `test.py:45-52`;
* every trial is appended to ``sweep_results.csv``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np

from object_detectors_tpu_torch.utils.config import CONFIG_DIR, Config, load_config

log = logging.getLogger("sweep")


def load_space(config_dir: str, name: str = "opt1"):
    import yaml

    with open(os.path.join(config_dir, "hp_optim", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def sobol_candidates(space: dict, n: int, seed: int = 0):
    """Draw n candidates over the range/choice space."""
    from scipy.stats import qmc

    params = space["params"]
    range_keys = [k for k, v in params.items() if v["type"] == "range"]
    choice_keys = [k for k, v in params.items() if v["type"] == "choice"]
    sampler = qmc.Sobol(d=len(range_keys) + len(choice_keys), seed=seed,
                        scramble=True)
    u = sampler.random(n)
    out = []
    for row in u:
        cand = {}
        for i, k in enumerate(range_keys):
            lo, hi = params[k]["bounds"]
            cand[k] = float(lo + row[i] * (hi - lo))
        for j, k in enumerate(choice_keys):
            vals = params[k]["values"]
            cand[k] = vals[min(int(row[len(range_keys) + j] * len(vals)),
                               len(vals) - 1)]
        out.append(cand)
    return out


def _encode(params_spec: dict, cand: dict) -> np.ndarray:
    """Candidate dict -> normalized [0,1]^d vector (choice params map to
    their value's index / (n-1))."""
    x = []
    for k, spec in params_spec.items():
        if spec["type"] == "range":
            lo, hi = spec["bounds"]
            x.append((cand[k] - lo) / max(hi - lo, 1e-12))
        else:
            vals = spec["values"]
            x.append(vals.index(cand[k]) / max(len(vals) - 1, 1))
    return np.asarray(x, np.float64)


def gp_propose(history: list, space: dict, rng: np.random.RandomState,
               pool: int = 512):
    """Model-based proposer: GP posterior + Expected Improvement.

    The reference runs Ax's model-based Bayesian optimization
    (`yolo/test.py:19-78` + hydra-ax-sweeper `hydra/hyperopt.yaml:27-41`,
    GP-EI after its Sobol init phase). This is the same loop without the
    Ax service: RBF-kernel GP fit on the normalized trial points
    (lengthscale picked from a small grid by marginal likelihood), EI
    maximized over a Sobol candidate pool.
    """
    params_spec = space["params"]
    X = np.stack([_encode(params_spec, h["params"]) for h in history])
    y = np.asarray([h["score"] for h in history], np.float64)
    # Failed trials carry the -1e7 sentinel; clamp to slightly below the
    # worst real score so they repel without flattening the GP.
    real = y > -1e6
    floor = (y[real].min() if real.any() else 0.0) - 1.0
    y = np.where(real, y, floor)
    mu, sd = y.mean(), max(y.std(), 1e-9)
    yn = (y - mu) / sd

    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    best_ll, best = -np.inf, None
    for ls in (0.1, 0.2, 0.3, 0.5, 0.7, 1.0, 2.0):
        K = np.exp(-0.5 * d2 / ls**2) + 1e-4 * np.eye(len(X))
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            continue
        a = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        ll = (-0.5 * yn @ a - np.log(np.diag(L)).sum())
        if ll > best_ll:
            best_ll, best = ll, (ls, L, a)
    if best is None:  # degenerate data — caller falls back to Sobol
        return None
    ls, L, a = best

    # Candidate pool: global Sobol + local perturbations around the best
    # trials (Ax's acquisition optimizer also restarts from incumbents;
    # a pure global pool under-exploits in 10-D at small trial counts).
    cands = sobol_candidates(space, pool // 2,
                             seed=int(rng.randint(1 << 30)))
    order = np.argsort(-y)
    for rank in range(min(3, len(order))):
        inc = history[int(order[rank])]["params"]
        for scale in (0.02, 0.05, 0.1, 0.2):
            for _ in range(pool // 16):
                cands.append(perturb(inc, space, rng, scale=scale))
    Xc = np.stack([_encode(params_spec, c) for c in cands])
    kx = np.exp(-0.5 * ((Xc[:, None, :] - X[None, :, :]) ** 2).sum(-1)
                / ls**2)                                   # [pool, n]
    mean = kx @ a
    v = np.linalg.solve(L, kx.T)                           # [n, pool]
    var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
    std = np.sqrt(var)
    y_best = yn.max()
    z = (mean - y_best - 0.01) / std  # small xi: favor exploitation
    # EI = std * (z * Phi(z) + phi(z))
    phi = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
    Phi = 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))
    ei = std * (z * Phi + phi)
    return cands[int(np.argmax(ei))]


def _erf(x):
    try:
        from scipy.special import erf
        return erf(x)
    except Exception:  # pragma: no cover — scipy is in the image
        return np.vectorize(__import__("math").erf)(x)


def perturb(incumbent: dict, space: dict, rng: np.random.RandomState,
            scale: float = 0.15):
    """Gaussian resample around the best candidate (exploit phase)."""
    params = space["params"]
    cand = {}
    for k, spec in params.items():
        if spec["type"] == "range":
            lo, hi = spec["bounds"]
            v = incumbent[k] + rng.randn() * scale * (hi - lo)
            cand[k] = float(np.clip(v, lo, hi))
        else:
            cand[k] = (incumbent[k] if rng.rand() > 0.3
                       else spec["values"][rng.randint(len(spec["values"]))])
    return cand


def one_epoch_objective(cfg: Config) -> float:
    """Single-epoch train -> metric (mAP or -val_loss), the `test.py:40-76`
    objective, on the configured device (``device``, the card by default).
    Returns -1e7 on failure."""
    from object_detectors_tpu_torch import main as pipeline
    from object_detectors_tpu_torch._device import resolve_device
    from object_detectors_tpu_torch.train import optim as optim_lib
    from object_detectors_tpu_torch.train import trainer

    try:
        device = resolve_device(cfg.get_path("device", "cuda"))
        loss_cfg = pipeline.build_loss_config(cfg)
        tx = optim_lib.make_optimizer(
            optim_lib.OptimizerConfig(lr=float(cfg.optimizer.lr)),
            optim_lib.SchedulerConfig(), 100)
        state = trainer.create_yolo_train_state(pipeline.build_model(cfg).to(device), tx)
        train_ds, gt_train = pipeline.build_dataset(cfg, "train")
        val_ds, gt_val = pipeline.build_dataset(cfg, "val")
        cw, il, _ = pipeline.build_tfidf(cfg, gt_train, device)
        state, sub, stats = pipeline.train_one_epoch(state, cfg, loss_cfg, train_ds, 0, cw, il)
        if sub is None:
            return -1e7
        if cfg.metric == "mAP":
            metric, _ = pipeline.test_one_epoch(state, cfg, loss_cfg, val_ds, gt_val)
            return metric
        return -pipeline.valid_one_epoch(state, cfg, loss_cfg, val_ds)
    except Exception:  # noqa: BLE001 — poisoned trial, like test.py
        log.exception("trial failed")
        return -1e7


def _spawned_trial(args):
    """Module-level worker for process-parallel trials (must pickle). The
    child runs on the device its overrides name, the parent's (the
    reference maps joblib workers onto GPUs, `yolo/test.py:23-24`; here
    the workers share the parent's card)."""
    config_dir, trial_overrides = args
    try:
        return float(one_epoch_objective(load_config(config_dir, trial_overrides)))
    except Exception:  # failed trial: poisoned like test.py:45-52
        return -1e7


def run_sweep(config_dir: str, overrides, max_trials: int | None = None,
              space_name: str = "opt1", out_csv: str = "sweep_results.csv",
              objective=one_epoch_objective, seed: int = 0,
              proposer: str = "gp", n_init: int | None = None,
              workers: int = 1):
    """proposer: 'gp' (Sobol init then GP-EI — the Ax model-based loop),
    'sobol' (pure quasi-random search), or 'perturb' (Sobol +
    incumbent perturbation, the round-1 behavior).

    workers > 1 evaluates trials in batch-synchronous rounds of that
    many SPAWNED processes (the `hydra/hyperopt.yaml:27-41` joblib
    launcher equivalent): a round's candidates come from the Sobol
    stream or one GP-EI proposal + incumbent-perturbation fill (a
    round is proposed before any of its scores exist), then the pool
    scores them concurrently on the parent's device and the history/GP
    advances once per round. workers=1 keeps the sequential loop and
    the caller's (possibly unpicklable) ``objective``."""
    space = load_space(config_dir, space_name)
    n = max_trials or int(space.get("max_trials", 20))
    d = len(space["params"])
    k_init = n_init if n_init is not None else max(5, min(d, n // 2))
    if proposer == "sobol":
        n_sobol = n
    elif proposer == "perturb":
        n_sobol = max(n // 2, 1)
    else:
        n_sobol = min(k_init, n)
    rng = np.random.RandomState(seed)
    candidates = sobol_candidates(space, n_sobol, seed)

    best_score, best_params = -np.inf, None
    rows = []
    history = []

    def propose(trial):
        if trial < len(candidates):
            return candidates[trial]
        if proposer == "gp":
            params = gp_propose(history, space, rng)
            if params is not None:
                return params
        return perturb(best_params or candidates[0], space, rng)

    trial = 0
    while trial < n:
        round_n = min(max(int(workers), 1), n - trial)
        batch_params = [propose(trial + j) for j in range(round_n)]
        if round_n > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            jobs = [(config_dir, list(overrides) + [
                f"{k}={v}" for k, v in p.items()]) for p in batch_params]
            with ProcessPoolExecutor(
                    max_workers=round_n,
                    mp_context=mp.get_context("spawn")) as pool:
                scores = list(pool.map(_spawned_trial, jobs))
        else:
            cfg = load_config(config_dir, list(overrides) + [
                f"{k}={v}" for k, v in batch_params[0].items()])
            scores = [objective(cfg)]
        for params, score in zip(batch_params, scores):
            rows.append({**params, "score": score, "trial": trial})
            history.append({"params": params, "score": score})
            if score > best_score:
                best_score, best_params = score, params
            log.info("trial %d score=%.5f best=%.5f", trial, score,
                     best_score)
            trial += 1

    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return best_params, best_score, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("overrides", nargs="*", help="config overrides (device=cpu for the CPU)")
    ap.add_argument("--config-dir", default=CONFIG_DIR)
    ap.add_argument("--max-trials", type=int, default=None)
    ap.add_argument("--space", default="opt1")
    ap.add_argument("--out", default="sweep_results.csv")
    ap.add_argument("--proposer", default="gp",
                    choices=["gp", "sobol", "perturb"])
    ap.add_argument("--workers", type=int, default=1,
                    help="process-parallel trials per round (joblib "
                         "launcher parity, hydra/hyperopt.yaml:27-41)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    best_params, best_score, _ = run_sweep(
        args.config_dir, args.overrides, args.max_trials, args.space,
        args.out, proposer=args.proposer, workers=args.workers)
    print(f"best score {best_score:.5f} with {best_params}")


if __name__ == "__main__":
    main()
