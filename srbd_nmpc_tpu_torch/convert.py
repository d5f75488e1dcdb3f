"""Parameters carried across from the JAX package, as numpy arrays.

The JAX dataclasses become dicts of numpy arrays on the JAX side
(``{f.name: np.asarray(getattr(obj, f.name))}``); these functions turn
such dicts into the port's structures, so both packages solve the same
problem. A field the port does not know, or one it needs and is not
given, is an error.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from srbd_nmpc_tpu_torch.models.srbd import SRBDParams
from srbd_nmpc_tpu_torch.nmpc.engine import NmpcConfig, NmpcState, NmpcWeights
from srbd_nmpc_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensors(cls, d: Mapping, dtype, device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = sorted(set(names) - set(d))
    extra = sorted(set(d) - set(names))
    if missing or extra:
        raise KeyError(f"{cls.__name__}: missing fields {missing}, "
                       f"unknown fields {extra}")
    dev = resolve_device(device)
    return cls(**{n: torch.as_tensor(np.array(d[n]), dtype=dtype, device=dev)
                  for n in names})


def params_from_numpy(d: Mapping, dtype=torch.float32,
                      device: DeviceLike = None) -> SRBDParams:
    return _tensors(SRBDParams, d, dtype, device)


def weights_from_numpy(d: Mapping, dtype=torch.float32,
                       device: DeviceLike = None) -> NmpcWeights:
    return _tensors(NmpcWeights, d, dtype, device)


def state_from_numpy(x, u, alpha, dtype=torch.float32,
                     device: DeviceLike = None) -> NmpcState:
    return _tensors(NmpcState, {"x": x, "u": u, "alpha": alpha}, dtype, device)


def config_from_jax_fields(d: Mapping) -> NmpcConfig:
    """Copy ``NmpcConfig`` fields by name; a field the port lacks raises."""
    names = {f.name for f in dataclasses.fields(NmpcConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise KeyError(f"NmpcConfig fields missing from the port: {unknown}")
    kw = dict(d)
    if "compact_tiers" in kw:
        kw["compact_tiers"] = tuple(int(f) for f in kw["compact_tiers"])
    return NmpcConfig(**kw)
