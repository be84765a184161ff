"""Command-line entry points of the port:

  python -m iadmm_tpu_torch.cli.train --config configs/qp_small.yaml ...

Flags mirror every field of :class:`iadmm_tpu_torch.config.ExperimentConfig`
(the JAX package's schema); flags override the YAML file, and unknown keys
are errors.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import ExperimentConfig


def config_parser(description: str) -> argparse.ArgumentParser:
    """argparse parser derived from the ExperimentConfig fields."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", default=None,
                   help="YAML config file (CLI flags override it)")
    for f in dataclasses.fields(ExperimentConfig):
        arg = f"--{f.name}"
        if f.type in ("bool", bool):
            # a bare '--flag' means true; '--flag false' is accepted too
            p.add_argument(arg, default=None, nargs="?", const=True,
                           type=lambda s: s.lower() in ("1", "true", "yes"),
                           help=f"(bool, default {f.default})")
        else:
            typ = {"int": int, "float": float, "str": str}.get(f.type, str)
            p.add_argument(arg, default=None, type=typ,
                           help=f"(default {f.default})")
    return p


def parse_config(args: argparse.Namespace) -> ExperimentConfig:
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(ExperimentConfig)
                 if getattr(args, f.name, None) is not None}
    if args.config:
        return ExperimentConfig.from_yaml(args.config, **overrides)
    return ExperimentConfig.from_dict(overrides)
