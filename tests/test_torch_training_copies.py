"""The port's copies and readers of salve_tpu's training inputs, on the CPU.

  * YAML configs: every salve_tpu/configs/*.yaml loads, through the port's
    own reader (no PyYAML), to a config equal to salve_tpu's
    `load_training_config`; the port's copy of each
    (salve_tpu_torch/configs/, `_target_` naming the port's class) loads,
    through the port's loader, to the original's config; a line outside the subset raises, naming it;
    the dataclass lists salve_tpu's fields in its order with its defaults;
  * weights: `convert_torchvision_resnet_state_dict` and `_widen_stem`
    equal salve_tpu's (carried by `state_dict_from_flax`), on state dicts
    made by tests/training/test_torch_weights.py:make_reference_state_dict;
  * calibration: the copied module's `fit_from_preds` on seeded batch JSONs
    gives salve_tpu's dict;
  * the `.flax` reader: every leaf of a salve_tpu TrainState payload equals
    flax's own msgpack_restore.
"""

import dataclasses
import glob
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from salve_tpu.models import torch_weights as jtw
from salve_tpu.training import calibration as jcal
from salve_tpu.training import config as jconfig
from salve_tpu_torch.models import weights as tw
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.training import calibration as tcal
from salve_tpu_torch.training import config as tconfig
from salve_tpu_torch.training.flax_checkpoint import read_flax_msgpack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(REPO / "salve_tpu" / "configs" / "*.yaml")))


# ---------------------------------------------------------------- (a) configs


@pytest.mark.parametrize("fpath", CONFIGS, ids=[Path(c).stem for c in CONFIGS])
def test_every_config_loads_as_salve_tpu_loads_it(fpath):
    got = tconfig.load_training_config(fpath)
    ref = jconfig.load_training_config(fpath)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert tconfig.read_config_yaml(fpath) == yaml.safe_load(open(fpath))


PORT_CONFIGS = REPO / "salve_tpu_torch" / "configs"
PORT_TARGET = "salve_tpu_torch.training.config.TrainingConfig"


def test_the_port_holds_a_copy_of_every_config():
    assert sorted(p.name for p in PORT_CONFIGS.glob("*.yaml")) == sorted(Path(c).name for c in CONFIGS)
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("fpath", CONFIGS, ids=[Path(c).stem for c in CONFIGS])
def test_the_ports_config_copy_loads_as_salve_tpus_original(fpath):
    """The copy, through the port's loader, and the original, through
    salve_tpu's, give equal TrainingConfigs; the copy's `_target_` names the
    port's class, and nothing else in it differs from the original."""
    copy = PORT_CONFIGS / Path(fpath).name
    got = tconfig.load_training_config(str(copy))
    ref = jconfig.load_training_config(fpath)
    assert isinstance(got, tconfig.TrainingConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    ours, theirs = tconfig.read_config_yaml(str(copy)), yaml.safe_load(open(fpath))
    assert ours["TrainingConfig"].pop("_target_") == PORT_TARGET
    assert theirs["TrainingConfig"].pop("_target_") == "salve_tpu.training.config.TrainingConfig"
    assert ours == theirs
    module, name = PORT_TARGET.rsplit(".", 1)
    assert getattr(importlib.import_module(module), name) is tconfig.TrainingConfig


def test_config_dataclass_equals_salve_tpus():
    ours = [(f.name, f.default, f.type) for f in dataclasses.fields(tconfig.TrainingConfig)]
    theirs = [(f.name, f.default, f.type) for f in dataclasses.fields(jconfig.TrainingConfig)]
    assert ours == theirs


@pytest.mark.parametrize("value,expected", [
    ("1.0e-3", 0.001), (".5", 0.5), ("-1.", -1.0), ("1_000", 1000), ("True", True), ("off", False),
    ("~", None), ("", None), ("'a b'", "a b"), ('"x"', "x"), ("plain words", "plain words"),
    ("[1, 'two', 3.5]", [1, "two", 3.5]), ("[]", []),
])
def test_scalars_resolve_as_pyyaml_resolves_them(tmp_path, value, expected):
    f = tmp_path / "c.yaml"
    f.write_text(f"# comment\nTrainingConfig:\n    key: {value}  # trailing\n")
    assert tconfig.read_config_yaml(str(f)) == {"TrainingConfig": {"key": expected}}
    assert yaml.safe_load(f.read_text()) == {"TrainingConfig": {"key": expected}}


@pytest.mark.parametrize("line", [
    "    mesh_shape:\n      - 1", "    x: 0x10", "    y: 007", "    z: 1e-3", "    t: 12:30",
    "    split_overrides: {a: b}", "    k: [a, [b]]", "    a: &anchor 1", "  shifted: 1",
    "Other:", "    base_lr: 0.5", "\tk: 1", "    s: 'it''s'",
])
def test_lines_outside_the_subset_raise_naming_the_line(tmp_path, line):
    base = (REPO / "salve_tpu" / "configs" / "default.yaml").read_text()
    f = tmp_path / "c.yaml"
    f.write_text(base + line + "\n")
    bad_line = len(base.splitlines()) + line.count("\n") + 1  # the appended text's last line
    with pytest.raises(tconfig.ConfigSyntaxError, match=rf"c\.yaml:{bad_line}(?!\d)"):
        tconfig.load_training_config(str(f))


def test_a_file_without_the_mapping_raises(tmp_path):
    f = tmp_path / "empty.yaml"
    f.write_text("# nothing\n")
    with pytest.raises(tconfig.ConfigSyntaxError, match="TrainingConfig"):
        tconfig.load_training_config(str(f))


# ---------------------------------------------------------------- (k) weights


def _make_reference_state_dict():
    """tests/training/test_torch_weights.py:make_reference_state_dict, loaded
    by path (tests/ has no packages)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_torch_weights_test", REPO / "tests" / "training" / "test_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_reference_state_dict


def _torchvision_layout(sd):
    """A vanilla torchvision ResNet state_dict from the early-fusion layout:
    the trunk without `resnet.`, its own 3-channel stem and 1000-class head."""
    out = {k[len("resnet."):]: v for k, v in sd.items() if k.startswith("resnet.")}
    out["fc.weight"] = torch.randn(1000, out["fc.weight"].shape[1])
    return out


@pytest.mark.parametrize("num_layers,n_imgs,seed", [(18, 4, 0), (50, 2, 1), (18, 6, 7)])
def test_convert_torchvision_resnet_equals_salve_tpu(num_layers, n_imgs, seed):
    make = _make_reference_state_dict()
    sd = _torchvision_layout(make(np.random.default_rng(seed), n_imgs=1, num_layers=num_layers))
    sd = {("module." + k if i % 3 == 0 else k): v for i, (k, v) in enumerate(sd.items())}
    params, stats = jtw.convert_torchvision_resnet_state_dict(sd, num_layers, n_imgs, rng_seed=seed)
    ref = tw.state_dict_from_flax(params, stats, num_layers)
    got = tw.convert_torchvision_resnet_state_dict(sd, num_layers, n_imgs, rng_seed=seed)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    modalities = {2: ("floor_rgb_texture",), 4: ("ceiling_rgb_texture", "floor_rgb_texture"),
                  6: ("ceiling_rgb_texture", "floor_rgb_texture", "layout")}[n_imgs]
    EarlyFusionCEResnet(num_layers=num_layers, modalities=modalities).load_state_dict(got, strict=True)


@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_widen_stem_equals_salve_tpu(n):
    k = np.random.default_rng(n).normal(0, 0.1, (64, 3, 7, 7)).astype(np.float32)
    ref = jtw._widen_stem(k.transpose(2, 3, 1, 0), n).transpose(3, 2, 0, 1)
    got = tw._widen_stem(k, n)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- (l) calibration


def _write_seeded_preds(d: Path, seed: int, n_batches: int = 4, batch: int = 32):
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        y_true = rng.integers(0, 2, batch)
        p_pos = np.clip(rng.normal(0.3 + 0.4 * y_true, 0.25), 0.001, 0.999)
        y_hat = (p_pos >= 0.5).astype(int)
        probs = np.where(y_hat == 1, p_pos, 1 - p_pos)
        (d / f"batch_{i}.json").write_text(json.dumps({
            "y_hat": y_hat.tolist(), "y_true": y_true.tolist(), "y_hat_probs": probs.tolist(),
            "fp0": [f"a_{j}.jpg" for j in range(batch)], "fp1": [f"b_{j}.jpg" for j in range(batch)]}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_copy_equals_salve_tpu(tmp_path, seed):
    _write_seeded_preds(tmp_path, seed)
    assert tcal.fit_from_preds(str(tmp_path)) == jcal.fit_from_preds(str(tmp_path))
    p, y = tcal.load_serialized_probs(str(tmp_path))
    rp, ry = jcal.load_serialized_probs(str(tmp_path))
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(y, ry)
    assert tcal.sweep_mAcc(p, y) == jcal.sweep_mAcc(rp, ry)
    with pytest.raises(FileNotFoundError):
        tcal.load_serialized_probs(str(tmp_path / "absent"))


def test_calibration_source_is_a_copy():
    """Past the docstring's first line and the copy note, the text is salve_tpu's."""
    ours = (REPO / "salve_tpu_torch" / "training" / "calibration.py").read_text().splitlines()
    theirs = (REPO / "salve_tpu" / "training" / "calibration.py").read_text().splitlines()
    assert ours[0] == theirs[0] and ours[4:] == theirs[2:]


# ---------------------------------------------------------------- the .flax reader


def test_flax_reader_equals_msgpack_restore(tmp_path):
    from flax import serialization

    from salve_tpu.training import train as jtrain
    from salve_tpu.training.config import TrainingConfig as JaxConfig

    cfg = JaxConfig(num_layers=18, compute_dtype="float32", train_h=32, train_w=32, mesh_shape=(1,))
    state = jtrain.create_train_state(cfg, jax.random.PRNGKey(0), 10)
    path = jtrain.save_checkpoint(str(tmp_path), state, 0, 0.5, cfg)
    data = Path(path).read_bytes()
    ref = serialization.msgpack_restore(data)
    got = read_flax_msgpack(data)

    def same(a, b, where=""):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), where

    same(got, ref)
    assert sorted(got) == ["batch_stats", "opt_state", "params", "step"]
    # Scalars, a bfloat16 array and a chunked array, written by flax.
    extra = {"f": np.float32(1.5), "i": np.int64(-3), "b": np.asarray(jax.numpy.arange(4, dtype=jax.numpy.bfloat16)),
             "c": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
                   "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}}
    got = read_flax_msgpack(serialization.msgpack_serialize(extra))
    assert got["f"] == np.float32(1.5) and got["i"] == -3
    np.testing.assert_array_equal(got["b"], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(got["c"], np.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError):
        read_flax_msgpack(data[:-5])
    # cli/test_fused.py loads the same checkpoint's weights.
    from salve_tpu_torch.cli.test_fused import load_verifier
    from salve_tpu_torch.training.config import TrainingConfig

    model = load_verifier(path, TrainingConfig(num_layers=18, compute_dtype="float32"))
    ref = tw.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                  jax.tree_util.tree_map(np.asarray, state.batch_stats), 18)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
