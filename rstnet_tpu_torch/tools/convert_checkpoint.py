"""Checkpoint conversion CLI: public PyTorch checkpoints -> this package's
parameters (counterpart of ``rstnet_tpu/tools/convert_checkpoint.py``).

Converts kyutai Mimi/Moshi safetensors and litgpt ``lit_model.pth`` files
through ``models/convert.py`` and saves them (float32, as converted):

    python -m rstnet_tpu_torch.tools.convert_checkpoint --kind mimi \\
        --input tokenizer-e351c8d8-checkpoint125.safetensors --output mimi_params
    python -m rstnet_tpu_torch.tools.convert_checkpoint --kind moshi --input model.safetensors ...
    python -m rstnet_tpu_torch.tools.convert_checkpoint --kind backbone \\
        --model_name Llama-3.2-1B --input lit_model.pth ...

``--format torch`` (the default; JAX's default is orbax, which has no
counterpart here) writes a weights-only export, ``<output>/state.pt`` under
the module's ``state_dict`` names (``training/checkpoint.py::save_model``),
which ``restore_checkpoint(output, {"model": module}, partial=True)`` loads.
``--format npz`` writes the same flat file as the JAX CLI's (JAX paths,
``export_numpy``). The conversion only renames and stacks tensors on the
host; it needs no device.
"""

from __future__ import annotations

import argparse
import logging

import torch


def convert(kind: str, path: str, model_name: str = "", model_config: str = ""):
    """(tree, stacked): the converted ``{JAX path: tensor}`` tree of a
    checkpoint file, and the prefixes its module keeps one layer apiece."""
    from rstnet_tpu_torch.models import convert as cv

    sd = cv.load_torch_state_dict(path)
    # the converters read only the modules' structure: build them without data
    shape_only = dict(device="meta", generator=torch.Generator())
    if kind == "mimi":
        from rstnet_tpu_torch.models.mimi import mimi_24k

        return cv.convert_mimi(sd, mimi_24k(**shape_only)), ()
    if kind == "moshi":
        from rstnet_tpu_torch.models.moshi_lm import moshi_7b

        return cv.convert_moshi_lm(sd, moshi_7b(**shape_only)), ()
    from rstnet_tpu_torch.models.backbone import STACKED
    from rstnet_tpu_torch.models.config import Config

    cfg = Config.from_file(model_config) if model_config else Config.from_name(model_name)
    return cv.convert_backbone(sd, cfg), STACKED


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True, choices=["mimi", "moshi", "backbone"])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--format", default="torch", choices=["torch", "npz"])
    parser.add_argument("--model_name", default="", help="backbone registry name")
    parser.add_argument("--model_config", default="", help="backbone config yaml")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from rstnet_tpu_torch.core import flatten_dict, unstack_layers
    from rstnet_tpu_torch.training.checkpoint import export_numpy, save_model

    tree, stacked = convert(args.kind, args.input, args.model_name, args.model_config)
    flat = dict(flatten_dict(tree))
    if args.format == "npz":
        export_numpy(args.output, flat)
    else:
        save_model(args.output, unstack_layers(flat, stacked))
    n = sum(t.numel() for t in flat.values())
    logging.info(f"converted {args.kind}: {n / 1e6:.2f} M params -> {args.output}")


if __name__ == "__main__":
    main()
