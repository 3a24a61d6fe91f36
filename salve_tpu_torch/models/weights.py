"""Weights into the port's models: the early-fusion verifier's, and the
depth nets' from salve_tpu's Flax trees (`depth_net_state_dict_from_flax`
for PanoDepthNet, `hohonet_state_dict_from_flax` for HoHoNet, the inverse
of salve_tpu's `convert_hohonet_state_dict`).

The verifier's three sources:
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

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from salve_tpu_torch.models.resnet import RESNET_SPECS

# Present in every reference checkpoint, unused by its forward pass (the
# early-fusion model replaces the trunk's stem and head).
_UNUSED_REFERENCE_PREFIXES = ("resnet.conv1.", "resnet.fc.")


def _t(a: Any) -> torch.Tensor:
    """A float32 tensor of `a`; float64 kept as float64 (a float64 model's
    weights, as JAX with x64 on holds them)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


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
    tp, ts = params["ResNet_0"], batch_stats["ResNet_0"]
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(tp["conv_init"]["kernel"])}
    _trunk_from_flax(sd, "resnet.", tp, ts, num_layers)
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def _trunk_from_flax(sd: Dict[str, torch.Tensor], prefix: str, tp: Mapping, ts: Mapping, num_layers: int) -> None:
    """A Flax ResNet trunk's bn_init and blocks (salve_tpu/models/resnet.py)
    as `{prefix}bn1` and `{prefix}layer{1..4}` of the port's ResNetTrunk."""
    kind, stage_sizes, _ = RESNET_SPECS[num_layers]
    block_name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    n_convs = 2 if kind == "basic" else 3
    _bn(sd, f"{prefix}bn1", tp["bn_init"], ts["bn_init"])
    k = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            bp, bs = tp[f"{block_name}_{k}"], ts[f"{block_name}_{k}"]
            t = f"{prefix}layer{stage}.{j}"
            for c in range(n_convs):
                sd[f"{t}.conv{c + 1}.weight"] = _conv(bp[f"Conv_{c}"]["kernel"])
                _bn(sd, f"{t}.bn{c + 1}", bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"])
            if "conv_proj" in bp:
                sd[f"{t}.downsample.0.weight"] = _conv(bp["conv_proj"]["kernel"])
                _bn(sd, f"{t}.downsample.1", bp["norm_proj"], bs["norm_proj"])
            k += 1


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping, n_in_axes: int = 1) -> None:
    """A Flax Dense, or a DenseGeneral whose first `n_in_axes` kernel axes
    are its inputs, as an nn.Linear: the kernel flattened to (in, out) and
    transposed, the bias flattened. Attention's q/k/v kernels are (C,
    heads, head_dim), its output kernel (heads, head_dim, C)."""
    kernel = np.asarray(p["kernel"])
    n_in = int(np.prod(kernel.shape[:n_in_axes]))
    sd[f"{name}.weight"] = _t(kernel.reshape(n_in, -1).T)
    sd[f"{name}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _trunk_depth(tp: Mapping) -> int:
    """ResNet depth of a Flax trunk, from its blocks' kind and count."""
    n_basic = sum(k.startswith("BasicBlock_") for k in tp)
    n_bottleneck = sum(k.startswith("BottleneckBlock_") for k in tp)
    for depth, (kind, stages, _) in RESNET_SPECS.items():
        if (kind == "basic" and n_basic == sum(stages)) or (kind == "bottleneck" and n_bottleneck == sum(stages)):
            return depth
    raise ValueError(f"no ResNet depth has {n_basic} basic and {n_bottleneck} bottleneck blocks")


def depth_net_state_dict_from_flax(
    params: Mapping, batch_stats: Mapping, num_layers: int = None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """salve_tpu's PanoDepthNet (params, batch_stats) -> (the port's
    state_dict, the PanoDepthNet keyword arguments it fits).

    The width, the block count and the decoder's height come from the
    tree's shapes; the trunk's depth from its blocks (`num_layers`, when
    given, must agree). The compute dtype is bfloat16, the Flax model's
    default.
    """
    tp, ts = params["_Trunk_0"], batch_stats["_Trunk_0"]
    depth = _trunk_depth(tp)
    if num_layers is not None and num_layers != depth:
        raise ValueError(f"the checkpoint's trunk is ResNet-{depth}, not ResNet-{num_layers}")
    sd: Dict[str, torch.Tensor] = {"trunk.conv1.weight": _conv(tp["conv_init"]["kernel"])}
    _trunk_from_flax(sd, "trunk.", tp, ts, depth)
    _dense(sd, "seq_proj", params["Dense_0"])
    _dense(sd, "pos_proj", params["Dense_1"])
    n_blocks = sum(k.startswith("TransformerBlock_") for k in params)
    for i in range(n_blocks):
        bp = params[f"TransformerBlock_{i}"]
        for ln, src in (("ln1", "LayerNorm_0"), ("ln2", "LayerNorm_1")):
            sd[f"blocks.{i}.{ln}.weight"] = _t(bp[src]["scale"])
            sd[f"blocks.{i}.{ln}.bias"] = _t(bp[src]["bias"])
        attn = bp["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            _dense(sd, f"blocks.{i}.attn.{name}", attn[name])
        _dense(sd, f"blocks.{i}.attn.out", attn["out"], n_in_axes=2)
        _dense(sd, f"blocks.{i}.mlp1", bp["Dense_0"])
        _dense(sd, f"blocks.{i}.mlp2", bp["Dense_1"])
    sd["norm.weight"] = _t(params["LayerNorm_0"]["scale"])
    sd["norm.bias"] = _t(params["LayerNorm_0"]["bias"])
    _dense(sd, "dense_decode", params["dense_decode"])
    for name in ("refine1", "refine2"):
        sd[f"{name}.weight"] = _conv(params[name]["kernel"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    embed_dim = int(np.asarray(params["Dense_0"]["kernel"]).shape[1])
    # The decoder's width fixes the input height (32 values a row); the
    # weights do not fix the width, taken as the panos' 2:1.
    rows = int(np.asarray(params["dense_decode"]["kernel"]).shape[1]) // 32
    config = {"num_layers": depth, "embed_dim": embed_dim, "num_blocks": n_blocks, "compute_dtype": "bfloat16",
              "input_hw": (rows, 2 * rows)}
    return sd, config


def hohonet_state_dict_from_flax(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """salve_tpu's HoHoNetDepth (params, batch_stats) -> the torch key
    layout: the inverse of salve_tpu/models/hohonet.py:406
    (`convert_hohonet_state_dict`)."""
    from salve_tpu_torch.models.hohonet import HARDNET68

    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(dst: str, p: Mapping, s: Mapping) -> None:
        sd[f"{dst}.conv.weight"] = _conv(p["conv"]["kernel"])
        _bn(sd, f"{dst}.norm", p["norm"], s["norm"])

    bp, bs = params["backbone"], stats["backbone"]
    for name in ("base_0", "base_1"):
        conv_bn(f"backbone.{name}", bp[name], bs[name])
    for i in range(5):
        for j in range(HARDNET68["n_layers"][i]):
            conv_bn(f"backbone.block_{i}.layers.{j}", bp[f"block_{i}"][f"layers_{j}"], bs[f"block_{i}"][f"layers_{j}"])
        conv_bn(f"backbone.trans_{i}", bp[f"trans_{i}"], bs[f"trans_{i}"])
    dp, ds = params["decode"], stats["decode"]
    for i in range(4):
        for j in range(4):
            conv_bn(f"decode.ghc_{i}.layer_{j}", dp[f"ghc_{i}"][f"layer_{j}"], ds[f"ghc_{i}"][f"layer_{j}"])
    sd["decode.proj.weight"] = _t(np.asarray(dp["proj"]["kernel"]).T[:, :, None])
    _bn(sd, "decode.proj_norm", dp["proj_norm"], ds["proj_norm"])
    rf = params["refine"]
    sd["refine.pos_embedding"] = _t(rf["pos_embedding"])
    sd["refine.attn.in_proj_weight"] = _t(np.asarray(rf["in_proj_kernel"]).T)
    sd["refine.attn.in_proj_bias"] = _t(rf["in_proj_bias"])
    for dst, src in (("attn.out_proj", "out_proj"), ("linear1", "linear1"), ("linear2", "linear2")):
        sd[f"refine.{dst}.weight"] = _t(np.asarray(rf[src]["kernel"]).T)
        sd[f"refine.{dst}.bias"] = _t(rf[src]["bias"])
    for name in ("norm1", "norm2"):
        sd[f"refine.{name}.weight"] = _t(rf[name]["scale"])
        sd[f"refine.{name}.bias"] = _t(rf[name]["bias"])
    sd["head.coef.weight"] = _t(np.asarray(params["head"]["coef"]["kernel"]).T[:, :, None])
    sd["head.coef.bias"] = _t(params["head"]["coef"]["bias"])
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
