"""Half Moons grid search (port of ``robustbnns_tpu/cli/grid_search_half_moons.py``;
reference ``grid_search_halfMoons.py`` main, ``:155-199``).

Example::

    python -m robustbnns_tpu_torch.cli.grid_search_half_moons --quick=True --device=cpu

The default sweep is the reference's (``:157-169``): 36 HMC cells of fc2
networks (hidden 32-512, warmup 100-500, 5,000-15,000 training points), 250
draws each; ``--quick`` shrinks it to one small cell. ``--host_id/--n_hosts``
(or ``ROBUSTBNNS_HOST_ID``/``ROBUSTBNNS_N_HOSTS``) give this worker its
round-robin share of the cells: ``--host_id=27 --n_hosts=36`` is the one
cell (hidden 512, warmup 100, 5,000 points). Trains (or resumes) each cell,
then its expected loss gradients (``--compute_grads``) and FGSM attacks
(``--compute_attacks``) on ``--test_points`` test points.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import boolean, setup_device, timed
from robustbnns_tpu_torch.config import resolve_rel_path

QUICK_SWEEP = dict(
    hidden_size=[32], activation=["leaky"], architecture=["fc2"], inference=["hmc"], epochs=[None], lr=[None],
    n_samples=[10], warmup=[10], n_inputs=[200],
)
REFERENCE_SWEEP = dict(  # reference :157-169
    hidden_size=[32, 128, 256, 512], activation=["leaky"], architecture=["fc2"], inference=["hmc"],
    epochs=[None], lr=[None], n_samples=[250], warmup=[100, 200, 500], n_inputs=[5000, 10000, 15000],
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Grid search BNN model")
    parser.add_argument("--test_points", default=100, type=int)
    parser.add_argument("--savedir", default="DATA", type=str, help="DATA, TESTS")
    parser.add_argument("--device", default="cuda", type=str, help="cuda, cpu")
    parser.add_argument("--compute_grads", default=True, type=boolean)
    parser.add_argument("--compute_attacks", default=False, type=boolean)
    parser.add_argument("--quick", default=False, type=boolean)
    parser.add_argument("--num_chains", default=1, type=int)
    parser.add_argument("--hmc_mode", default="faithful", type=str, help="faithful, full")
    parser.add_argument("--sampler", default="hmc", type=str, help="hmc, nuts")
    parser.add_argument("--host_id", default=None, type=int)
    parser.add_argument("--n_hosts", default=None, type=int)
    return parser


def run(args) -> dict:
    """Train this worker's cells, then their gradients and attacks; ``args`` is a
    parsed namespace or a list of flags. Returns the cells, the trained BNNs,
    the gradients and adversarial sets (cell-major, as computed), the
    directory and the seconds of each stage (synchronised with the card)."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device)

    from robustbnns_tpu_torch.experiments.grid_search import (
        grid_attack,
        grid_cells_for_host,
        grid_combinations,
        grid_compute_grads,
        grid_train,
    )
    from robustbnns_tpu_torch.parallel import host_identity

    sweep = QUICK_SWEEP if args.quick else REFERENCE_SWEEP
    posterior_samples = [10] if args.quick else [250]
    host_id, n_hosts = host_identity(args.host_id, args.n_hosts)
    rel_path = resolve_rel_path(args.savedir)
    cells = grid_cells_for_host(grid_combinations(**sweep), host_id, n_hosts)
    print(f"grid: {len(cells)} cells on host {host_id}/{n_hosts}")

    result = {"cells": cells, "rel_path": rel_path, "posterior_samples": posterior_samples}
    result["trained"], result["train_seconds"] = timed(device, lambda: grid_train(
        cells, rel_path, num_chains=args.num_chains, hmc_mode=args.hmc_mode, sampler=args.sampler, device=device))
    if args.compute_grads:
        result["grads"], result["grads_seconds"] = timed(device, lambda: grid_compute_grads(
            cells, posterior_samples, args.test_points, rel_path, device=device))
    if args.compute_attacks:
        result["attacks"], result["attack_seconds"] = timed(device, lambda: grid_attack(
            cells, posterior_samples, args.test_points, "fgsm", rel_path, device=device))
    return result


def main(args) -> dict:
    """:func:`run`; the grid search draws no figure."""
    return run(args)


if __name__ == "__main__":
    main(build_parser().parse_args())
