"""Expected loss gradients over increasing sample counts (port of
``robustbnns_tpu/cli/loss_gradients.py``; reference ``lossGradients.py`` main,
``:130-151``).

Example::

    python -m robustbnns_tpu_torch.cli.loss_gradients --n_inputs=10 --model_idx=0 \
        --device=cpu

Loads the saved posterior of ``--model_idx`` (SVI, or an HMC model's stacked
draws, of which S = 100 needs all of the configured 100) and saves one
``<name>_samp=<n>_lossGrads.npz`` per sample count.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, load_data, setup_device
from robustbnns_tpu_torch.config import resolve_rel_path, saved_BNNs

POSTERIOR_SAMPLES_LIST = [1, 10, 50, 100]  # reference :132


def build_parser() -> argparse.ArgumentParser:
    return add_common_flags(argparse.ArgumentParser(), n_inputs_default=1000)


def main(args) -> dict:
    """Load the posterior and compute its expected loss gradients on the first
    ``--n_inputs`` test images for S in 1, 10, 50, 100; ``args`` is a parsed
    namespace or a list of flags. Returns ``{S: gradients}`` as numpy arrays."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.analysis import loss_gradients
    from robustbnns_tpu_torch.models.bnn import BNN

    cfg = saved_BNNs[f"model_{args.model_idx}"]
    rel_path = resolve_rel_path(args.savedir)
    _, _, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device).load(rel_path=rel_path)
    return {
        posterior_samples: loss_gradients(
            bnn, x_test, y_test, n_samples=posterior_samples,
            filename=bnn.name, savedir=bnn.name, rel_path=rel_path,
        )
        for posterior_samples in POSTERIOR_SAMPLES_LIST
    }


if __name__ == "__main__":
    main(build_parser().parse_args())
