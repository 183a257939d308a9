"""Half Moons grid search (port of ``robustbnns_tpu/experiments/grid_search.py``;
reference ``grid_search_halfMoons.py``).

Every cell's artifacts are keyed by the reference's name-mangled config
string, so the loop restarts where it stopped, and workers split the cell list
round-robin (``grid_cells_for_host``) with disk as the only channel, as the
reference's joblib workers do (``:52-60``).

``MoonsBNN`` parity: dataset ``half_moons``, HMC ``step_size=0.001``
(``grid_search_halfMoons.py:18-24``), the name includes ``n_inputs``; batch
size 64 for SVI and 1024 for HMC (``:33``).
"""
from __future__ import annotations

import itertools
import os
from typing import Iterable, Sequence

from robustbnns_tpu_torch.config import TESTS, BNNConfig


def moons_config(hidden_size, activation, architecture, inference, epochs, lr, n_samples, warmup) -> BNNConfig:
    """A Half-Moons BNN config (reference ``MoonsBNN``, ``:18-24``)."""
    return BNNConfig(
        dataset="half_moons", hidden_size=hidden_size, activation=activation, architecture=architecture,
        inference=inference, epochs=epochs, lr=lr, n_samples=n_samples, warmup=warmup, step_size=0.001,
    )


def grid_combinations(
    hidden_size, activation, architecture, inference, epochs, lr, n_samples, warmup, n_inputs,
) -> list[tuple]:
    """Cartesian product in the reference's axis order (``:46-47``)."""
    return list(itertools.product(
        hidden_size, activation, architecture, inference, epochs, lr, n_samples, warmup, n_inputs))


def grid_cells_for_host(cells: Sequence, host_id: int | None = None, n_hosts: int | None = None) -> list:
    """This worker's grid cells (round-robin; :func:`.parallel.partition_for_host`)."""
    from robustbnns_tpu_torch.parallel.distributed import partition_for_host

    return partition_for_host(cells, host_id, n_hosts)


def moons_batch_size(inference: str) -> int:
    return 64 if inference == "svi" else 1024  # reference :33


def _cell_bnn(cell, inp_shape, out_size, device):
    from robustbnns_tpu_torch.models.bnn import BNN

    *cfg_args, n_inputs = cell
    return BNN.from_config(moons_config(*cfg_args), inp_shape, out_size, n_inputs=n_inputs, device=device)


def grid_train(
    cells: Iterable[tuple],
    rel_path: str = TESTS,
    *,
    num_chains: int = 1,
    hmc_mode: str = "faithful",
    sampler: str = "hmc",
    save: bool = True,
    resume: bool = True,
    verbose: bool = True,
    device="cuda",
) -> list:
    """Train and save every grid cell (reference ``_train``/``serial_train``, ``:30-50``).

    ``resume=True`` loads a cell whose ``<name>/<name>_weights.npz`` exists
    instead of training it; ``save=False`` trains without writing.
    ``sampler='nuts'`` samples the HMC cells by NUTS (use another
    ``rel_path``: the names do not say which sampler ran). Returns the BNNs.
    """
    from robustbnns_tpu_torch.data.datasets import load_dataset

    trained = []
    for cell in cells:
        x_train, y_train, _, _, inp_shape, out_size = load_dataset("half_moons", n_inputs=cell[-1], shuffle=False)
        bnn = _cell_bnn(cell, inp_shape, out_size, device)
        ckpt = os.path.join(rel_path, bnn.name, bnn.name + "_weights.npz")
        if resume and os.path.exists(ckpt):
            if verbose:
                print(f"\n=== grid cell (resumed from checkpoint): {bnn.name}")
            trained.append(bnn.load(rel_path=rel_path))
            continue
        if verbose:
            print(f"\n=== grid cell: {bnn.name}")
        bnn.train(x_train, y_train, batch_size=moons_batch_size(bnn.config.inference), num_chains=num_chains,
                  hmc_mode=hmc_mode, hmc_sampler=sampler, verbose=verbose)
        if save:
            bnn.save(rel_path=rel_path)
        trained.append(bnn)
    return trained


def grid_compute_grads(
    cells: Iterable[tuple],
    posterior_samples_list: Sequence[int],
    test_points: int,
    rel_path: str = TESTS,
    verbose: bool = True,
    device="cuda",
) -> list:
    """Expected gradients per (cell, posterior samples), saved under each
    cell's name (reference ``_compute_grads``, ``:66-99``); returns them in
    that order, as :func:`.analysis.loss_gradients` returns them."""
    from robustbnns_tpu_torch.analysis import loss_gradients
    from robustbnns_tpu_torch.data.datasets import load_dataset

    _, _, x_test, y_test, inp_shape, out_size = load_dataset("half_moons", n_inputs=test_points, shuffle=True)
    grads = []
    for cell in cells:
        bnn = _cell_bnn(cell, inp_shape, out_size, device).load(rel_path=rel_path)
        for p_samp in posterior_samples_list:
            grads.append(loss_gradients(bnn, x_test, y_test, n_samples=p_samp, filename=bnn.name,
                                        savedir=bnn.name, rel_path=rel_path, verbose=verbose))
    return grads


def grid_attack(
    cells: Iterable[tuple],
    posterior_samples_list: Sequence[int],
    test_points: int,
    method: str = "fgsm",
    rel_path: str = TESTS,
    verbose: bool = True,
    device="cuda",
) -> list:
    """Attack per (cell, posterior samples), saved under each cell's name
    (reference ``grid_attack``, ``:133-153``); returns the adversarial sets."""
    from robustbnns_tpu_torch.attacks import attack
    from robustbnns_tpu_torch.data.datasets import load_dataset

    _, _, x_test, y_test, inp_shape, out_size = load_dataset("half_moons", n_inputs=test_points)
    attacks = []
    for cell in cells:
        bnn = _cell_bnn(cell, inp_shape, out_size, device).load(rel_path=rel_path)
        for p_samp in posterior_samples_list:
            attacks.append(attack(bnn, x_test, y_test, method=method, n_samples=p_samp, filename=bnn.name,
                                  rel_path=rel_path, verbose=verbose))
    return attacks
