"""The port's early-fusion verifier against the Flax model, float32.

Flax parameters carried by `state_dict_from_flax`, and reference-format
torch checkpoints loaded natively with `strict=True`, must give the Flax
model's logits within 1e-4 of the largest logit's magnitude (random
weights give logits in the hundreds; float32 sums in another order differ
by ~1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.models import torch_weights as jtw
from salve_tpu.models.early_fusion import EarlyFusionCEResnet as FlaxEarlyFusion
from salve_tpu.models.resnet import RESNET_SPECS as JAX_SPECS
from salve_tpu_torch.models import weights
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet, num_images_for_modalities
from salve_tpu_torch.models.resnet import RESNET_SPECS

MODALITIES = ("ceiling_rgb_texture", "floor_rgb_texture")


def _randomize(tree, rng):
    """Perturb a Flax variable tree so every block's residual branch is live
    (Flax zero-initializes each block's last BN scale)."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "scale":
            return rng.uniform(0.3, 1.0, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flax_and_port(num_layers, hw, seed=0):
    flax_model = FlaxEarlyFusion(num_layers=num_layers, modalities=MODALITIES, compute_dtype=jnp.float32)
    v = flax_model.init(jax.random.PRNGKey(seed), [jnp.zeros((1, hw, hw, 3))] * 4, train=False)
    rng = np.random.default_rng(seed)
    params, stats = _randomize(v["params"], rng), _randomize(v["batch_stats"], rng)
    model = EarlyFusionCEResnet(num_layers=num_layers, modalities=MODALITIES, compute_dtype="float32")
    model.load_state_dict(weights.state_dict_from_flax(params, stats, num_layers), strict=True)
    return flax_model, params, stats, model.eval()


def _images(seed, b, hw):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, hw, hw, 3)).astype(np.float32) for _ in range(4)]


def _assert_logits_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= 1e-4 * scale, (np.abs(got - ref).max(), scale)


def _port_logits(model, imgs):
    with torch.no_grad():
        return model([torch.from_numpy(x).permute(0, 3, 1, 2) for x in imgs]).numpy()


def test_specs_match_jax():
    assert RESNET_SPECS == JAX_SPECS
    for mods in (("layout",), MODALITIES, MODALITIES + ("layout",)):
        from salve_tpu.models.early_fusion import num_images_for_modalities as jax_n

        assert num_images_for_modalities(mods) == jax_n(mods)


@pytest.mark.parametrize("num_layers", [18, 50])
def test_state_dict_from_flax_gives_flax_logits(num_layers):
    flax_model, params, stats, model = _flax_and_port(num_layers, 56)
    imgs = _images(1, 2, 56)
    ref = np.asarray(flax_model.apply({"params": params, "batch_stats": stats}, [jnp.asarray(x) for x in imgs], train=False))
    got = _port_logits(model, imgs)
    assert np.abs(ref).max() > 1e-2
    _assert_logits_close(got, ref)


@pytest.mark.parametrize("num_layers", [18, 50])
def test_reference_checkpoint_loads_strict_and_matches_flax(num_layers, tmp_path):
    """A reference-layout checkpoint (DataParallel `module.` prefix, unused
    trunk stem/head) loads natively and agrees with the Flax model given the
    same checkpoint through convert_early_fusion_state_dict."""
    rng = np.random.default_rng(2)
    sd = _reference_state_dict(rng, num_layers)
    path = tmp_path / "train_ckpt.pth"
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)

    model = EarlyFusionCEResnet(num_layers=num_layers, modalities=MODALITIES, compute_dtype="float32")
    weights.load_reference_checkpoint(str(path), model)
    model.eval()

    params, stats = jtw.convert_early_fusion_state_dict(sd, num_layers=num_layers)
    flax_model = FlaxEarlyFusion(num_layers=num_layers, modalities=MODALITIES, compute_dtype=jnp.float32)
    imgs = _images(3, 2, 56)
    ref = np.asarray(flax_model.apply({"params": params, "batch_stats": stats}, [jnp.asarray(x) for x in imgs], train=False))
    _assert_logits_close(_port_logits(model, imgs), ref)

    # Strict: an unknown key is refused, and only the unused entries are dropped.
    sd_bad = dict(sd, **{"resnet.layer1.0.extra": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load_state_dict(weights.port_state_dict_from_reference(sd_bad), strict=True)
    kept = weights.port_state_dict_from_reference(sd)
    assert set(sd) - set(kept) == {"resnet.conv1.weight", "resnet.fc.weight", "resnet.fc.bias"}


def test_bf16_compute_keeps_float32_parameters_and_logits():
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="bfloat16").eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        logits = model([torch.zeros(1, 3, 32, 32)] * 4)
    assert logits.dtype == torch.float32 and logits.shape == (1, 2)


def _reference_state_dict(rng, num_layers, n_imgs=4, num_classes=2):
    """Reference EarlyFusionCEResnet.state_dict() layout, made the way
    tests/training/test_torch_weights.py:make_reference_state_dict makes it."""
    def conv(cout, cin, k):
        return torch.tensor(rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32))

    def bn(c, prefix):
        sd[f"{prefix}.weight"] = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.tensor(rng.normal(0, 0.1, c).astype(np.float32))
        sd[f"{prefix}.running_mean"] = torch.tensor(rng.normal(0, 0.1, c).astype(np.float32))
        sd[f"{prefix}.running_var"] = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32))

    kind, stage_sizes, feature_dim = RESNET_SPECS[num_layers]
    sd = {"conv1.weight": conv(64, 3 * n_imgs, 7), "resnet.conv1.weight": conv(64, 3, 7)}
    sd["resnet.fc.weight"] = torch.zeros((1000, feature_dim))
    sd["resnet.fc.bias"] = torch.zeros(1000)
    bn(64, "resnet.bn1")
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        planes = 64 * 2 ** (stage - 1)
        cout = planes if kind == "basic" else planes * 4
        for j in range(n_blocks):
            t = f"resnet.layer{stage}.{j}"
            if kind == "basic":
                sd[f"{t}.conv1.weight"] = conv(planes, cin, 3)
                bn(planes, f"{t}.bn1")
                sd[f"{t}.conv2.weight"] = conv(planes, planes, 3)
                bn(planes, f"{t}.bn2")
            else:
                sd[f"{t}.conv1.weight"] = conv(planes, cin, 1)
                bn(planes, f"{t}.bn1")
                sd[f"{t}.conv2.weight"] = conv(planes, planes, 3)
                bn(planes, f"{t}.bn2")
                sd[f"{t}.conv3.weight"] = conv(cout, planes, 1)
                bn(cout, f"{t}.bn3")
            if cin != cout:
                sd[f"{t}.downsample.0.weight"] = conv(cout, cin, 1)
                bn(cout, f"{t}.downsample.1")
            cin = cout
    sd["fc.weight"] = torch.tensor(rng.normal(0, 0.05, (num_classes, feature_dim)).astype(np.float32))
    sd["fc.bias"] = torch.tensor(rng.normal(0, 0.05, num_classes).astype(np.float32))
    return sd
