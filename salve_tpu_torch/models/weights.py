"""Verifier weights into the port's EarlyFusionCEResnet.

Two sources:
  * `state_dict_from_flax` — the JAX package's Flax (params, batch_stats)
    as numpy arrays; the inverse of
    salve_tpu/models/torch_weights.py:convert_early_fusion_state_dict.
    HWIO -> OIHW for convs, kernel.T for the head, scale/bias/mean/var for
    batch norm.
  * `load_reference_checkpoint` — a reference `train_ckpt.pth`, loaded
    natively: the port keeps the reference's key names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from salve_tpu_torch.models.resnet import RESNET_SPECS

# Present in every reference checkpoint, unused by its forward pass (the
# early-fusion model replaces the trunk's stem and head).
_UNUSED_REFERENCE_PREFIXES = ("resnet.conv1.", "resnet.fc.")


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel_hwio: Any) -> torch.Tensor:
    return _t(np.asarray(kernel_hwio).transpose(3, 2, 0, 1))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def state_dict_from_flax(
    params: Mapping, batch_stats: Mapping, num_layers: int
) -> Dict[str, torch.Tensor]:
    """Flax EarlyFusionCEResnet (params, batch_stats) -> the port's state_dict."""
    kind, stage_sizes, _ = RESNET_SPECS[num_layers]
    block_name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    n_convs = 2 if kind == "basic" else 3
    tp, ts = params["ResNet_0"], batch_stats["ResNet_0"]

    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(tp["conv_init"]["kernel"])}
    _bn(sd, "resnet.bn1", tp["bn_init"], ts["bn_init"])
    k = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            bp, bs = tp[f"{block_name}_{k}"], ts[f"{block_name}_{k}"]
            t = f"resnet.layer{stage}.{j}"
            for c in range(n_convs):
                sd[f"{t}.conv{c + 1}.weight"] = _conv(bp[f"Conv_{c}"]["kernel"])
                _bn(sd, f"{t}.bn{c + 1}", bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"])
            if "conv_proj" in bp:
                sd[f"{t}.downsample.0.weight"] = _conv(bp["conv_proj"]["kernel"])
                _bn(sd, f"{t}.downsample.1", bp["norm_proj"], bs["norm_proj"])
            k += 1
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def port_state_dict_from_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DataParallel's `module.` and drop the unused trunk stem/head."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith(_UNUSED_REFERENCE_PREFIXES):
            out[k] = v
    return out


def load_reference_checkpoint(ckpt_fpath: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference `train_ckpt.pth` (or a bare state_dict) into `model`.

    Strict: every remaining key must match the model's, and every parameter
    must be present.
    """
    ckpt = torch.load(ckpt_fpath, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model.load_state_dict(port_state_dict_from_reference(sd), strict=True)
    return model
