"""Verifier weights into the port's EarlyFusionCEResnet.

Three sources:
  * `state_dict_from_flax` — the JAX package's Flax (params, batch_stats)
    as numpy arrays; the inverse of
    salve_tpu/models/torch_weights.py:convert_early_fusion_state_dict.
    HWIO -> OIHW for convs, kernel.T for the head, scale/bias/mean/var for
    batch norm.
  * `read_verifier_checkpoint` — a reference `train_ckpt.pth`, loaded
    natively (the port keeps the reference's key names), the port's
    `train_ckpt.pt`, or salve_tpu's `train_ckpt.flax`; the one place that
    tells these formats apart (`load_reference_checkpoint` loads its result);
  * `convert_torchvision_resnet_state_dict` — a vanilla torchvision
    ImageNet ResNet state_dict (a local `.pth`; nothing is downloaded) as
    the early-fusion model's start, as
    salve_tpu/models/torch_weights.py:136 makes it: the trunk verbatim, the
    stem tiled over the image slots (`_widen_stem`), a fresh head drawn from
    `np.random.default_rng(rng_seed)` exactly as there.
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


def _strip_module(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip DataParallel's `module.` key prefix."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def port_state_dict_from_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DataParallel's `module.` and drop the unused trunk stem/head."""
    return {k: v for k, v in _strip_module(sd).items() if not k.startswith(_UNUSED_REFERENCE_PREFIXES)}


def read_verifier_checkpoint(ckpt_fpath: str, num_layers: int) -> Dict[str, Any]:
    """Any verifier checkpoint the port accepts, as {"model": state_dict}
    plus "opt_state" and "step" for a training checkpoint:

      * salve_tpu's `train_ckpt.flax` (training/flax_checkpoint.py);
      * the port's `train_ckpt.pt` ({"model", "opt_state", "step"},
        training/train.py:save_checkpoint);
      * a reference `train_ckpt.pth` ({"state_dict": ...}) or a bare
        state_dict, through `port_state_dict_from_reference`.
    """
    if ckpt_fpath.endswith(".flax"):
        from salve_tpu_torch.training.flax_checkpoint import flax_checkpoint_to_port

        return flax_checkpoint_to_port(ckpt_fpath, num_layers)
    ckpt = torch.load(ckpt_fpath, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and "opt_state" in ckpt:
        return ckpt
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {"model": port_state_dict_from_reference(sd)}


def load_reference_checkpoint(ckpt_fpath: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference `train_ckpt.pth` (or a bare state_dict) into `model`.

    Strict: every remaining key must match the model's, and every parameter
    must be present.
    """
    model.load_state_dict(read_verifier_checkpoint(ckpt_fpath, model.num_layers)["model"], strict=True)
    return model


def _np32(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _widen_stem(kernel_rgb: np.ndarray, num_input_images: int) -> np.ndarray:
    """Tile a pretrained (64, 3, kh, kw) stem kernel over the image slots,
    scaled by 1 / n (salve_tpu/models/torch_weights.py:103, in OIHW)."""
    tiled = np.concatenate([kernel_rgb] * num_input_images, axis=1)
    return tiled / float(num_input_images)


def convert_torchvision_resnet_state_dict(
    sd: Mapping[str, Any],
    num_layers: int,
    num_input_images: int,
    num_classes: int = 2,
    rng_seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """Vanilla torchvision ImageNet state_dict -> the port's early-fusion state_dict.

    The trunk (bn1, layer1..4) is taken verbatim under `resnet.`; the stem
    is tiled to 3 * num_input_images channels; the 1000-class head is
    replaced by a fresh `num_classes` head: kernel
    N(0, 1 / feature_dim) from `np.random.default_rng(rng_seed)`, zero bias.
    """
    sd = _strip_module(sd)
    kind, stage_sizes, feature_dim = RESNET_SPECS[num_layers]
    n_convs = 2 if kind == "basic" else 3
    out: Dict[str, torch.Tensor] = {"conv1.weight": _t(_widen_stem(_np32(sd["conv1.weight"]), num_input_images))}

    def bn(src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = _t(_np32(sd[f"{src}.{leaf}"]))
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    bn("bn1", "resnet.bn1")
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            t = f"layer{stage}.{j}"
            for c in range(1, n_convs + 1):
                out[f"resnet.{t}.conv{c}.weight"] = _t(_np32(sd[f"{t}.conv{c}.weight"]))
                bn(f"{t}.bn{c}", f"resnet.{t}.bn{c}")
            if f"{t}.downsample.0.weight" in sd:
                out[f"resnet.{t}.downsample.0.weight"] = _t(_np32(sd[f"{t}.downsample.0.weight"]))
                bn(f"{t}.downsample.1", f"resnet.{t}.downsample.1")
    rng = np.random.default_rng(rng_seed)
    fc_kernel = rng.normal(0.0, 1.0 / np.sqrt(feature_dim), (feature_dim, num_classes)).astype(np.float32)
    out["fc.weight"] = _t(fc_kernel.T)
    out["fc.bias"] = torch.zeros(num_classes, dtype=torch.float32)
    return out
