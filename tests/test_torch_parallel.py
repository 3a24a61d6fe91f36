"""The port on a mesh of gloo ranks on the CPU against salve_tpu's mesh of the same size.

One group of 2 ranks and one of 3 are spawned once for the module
(`salve_tpu_torch.parallel.launch`, one thread a rank, a `file://` store in
a temporary directory); each rank runs tests/torch_parallel_work.py, which
imports the port only, and returns its results. salve_tpu runs in this
process on `make_mesh((n,), devices=jax.devices()[:n])` (tests/conftest.py
gives JAX 8 CPU devices), on the same inputs made from seeds with numpy,
the same weights (carried by `state_dict_from_flax`) and the augmentation
parameters JAX draws. The port takes its kernels' plain versions (CPU
tensors). Bounds:

  * the scorer, direct and warp mode, on the tiny setup of
    tests/pipeline/test_fused_inference.py at batch 4 over 2 ranks: every
    rank returns the whole list, equal on both ranks; each rank's rows equal
    bit for bit the one-device scorer run at batch 2 over the same rows
    (the unmodified one-card body on the local shard); y_hat equals
    salve_tpu's mesh and the probabilities are within 1e-3 of it (the
    one-device port is held to salve_tpu at that bound,
    tests/test_torch_fused_slice.py: renders differ in a few pixels where a
    one-ulp trigonometric difference moves a round()) and within rtol 1e-5
    of the port's own one-device scorer, as tests/pipeline/test_fused_inference.py
    holds salve_tpu's mesh to its one device; a batch the mesh does not
    divide raises salve_tpu's ValueError;
  * `DeviceCorpus.iter_batches` at n = 2 and 3, shuffled and not, with
    wrap-around padding (31 tuples): images, labels, tuples and `valid`
    equal, and the two ValueErrors;
  * one train step at n = 2, plain and class-balanced: test_torch_training's
    `_compare_step` bounds (loss 1e-5, gradients 1e-4 of max|g|, batch-norm
    running statistics 1e-5, Adam moments 1e-4, parameters), the global
    probabilities within 1e-5, every rank's state equal bit for bit;
  * a divisible batch then a tail batch of 5 through `run_epoch`: equal
    accuracies, the loss within rtol 1e-3 (train()'s bound), running
    statistics within 1e-5 and parameters within 2 lr after the two steps,
    both ranks equal bit for bit;
  * `train()` for 2 epochs of 2 steps: losses within rtol 1e-3 (as
    test_torch_training holds it on one device), only rank 0 writes;
  * `evaluate()`: rank 0's batch_{i}.json equal salve_tpu's in y_hat,
    y_true, fp0 and fp1, probabilities within 1e-4;
  * the CLI with `--mesh_devices 2 --device cpu` starts its ranks and writes
    the files of the world of one: equal but for the probabilities, within
    rtol 1e-5 (each rank scores half a batch).
"""

import concurrent.futures
import glob
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.common.alignment_hypothesis import AlignmentHypothesis as JaxHypothesis
from salve_tpu.dataset import bev_pairs as jbp
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from salve_tpu.pipeline.fused_inference import score_floor_hypotheses as jax_score
from salve_tpu.rendering.bev_pair import BEVRenderConfig as JaxRenderConfig
from salve_tpu.training import device_corpus as jdc
from salve_tpu.training import loop as jloop
from salve_tpu.training import train as jtrain
from salve_tpu.training.config import TrainingConfig as JaxConfig
from salve_tpu_torch.cli import test_fused
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.models.weights import state_dict_from_flax
from salve_tpu_torch.parallel import launch
from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training import train as ttrain
from salve_tpu_torch.training.config import TrainingConfig
from test_torch_bev_pairs import TEST_ID, TRAIN_IDS, VAL_ID, _jax_aug_params, listing_sorted_make_dataset, write_bev_tree
from test_torch_fused_slice import RENDER, TINY, _read_batches, _write_building
from test_torch_training import SMALL, _compare_step, _copy, _decode_like_salve_tpu_native, _jax_train_draws
from torch_parallel_work import FakeDataset, HostBatches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
POSES = [(15.0 * k, 0.2 * k - 1.0, 0.1 * k) for k in range(10)]
BATCH = 4
CORPUS_CASES = {2: [(50, 8), (31, 8)], 3: [(50, 6), (31, 6)]}


def _hyps(hyp_cls, sim2_cls):
    return [(3, 5, hyp_cls(i2Ti1=sim2_cls.from_theta_deg(th, np.array([tx, ty])), wdo_alignment_object="door",
                           i1_wdo_idx=k, i2_wdo_idx=0, configuration="identity"))
            for k, (th, tx, ty) in enumerate(POSES)]


def _layouts():
    """Two panos' layouts: a square room with a door and a window, and a
    pentagon with none."""
    from salve_tpu_torch.common.wdo import WDO

    wdo = lambda a, b, t: WDO(Sim2.identity(), a, b, -np.nan, np.nan, t)  # noqa: E731
    square = np.array([[-1.5, -1.0], [1.5, -1.0], [1.5, 1.2], [-1.5, 1.2]])
    pentagon = np.array([[np.cos(a), np.sin(a)] for a in np.linspace(0, 2 * np.pi, 5, endpoint=False)]) * 1.8
    return [(square, [wdo((-0.5, -1.0), (0.4, -1.0), "doors"), wdo((1.5, 0.0), (1.5, 0.8), "windows")]),
            (pentagon, [])]


def _weights(state, num_layers):
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return state_dict_from_flax(tree(state.params), tree(state.batch_stats), num_layers)


def _mesh(n):
    return make_mesh((n,), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """salve_tpu's states and draws, and the inputs of both sides."""
    root = tmp_path_factory.mktemp("parallel")
    tiny_state = jtrain.create_train_state(JaxConfig(**TINY), jax.random.PRNGKey(0), max_iter=10)
    rng = np.random.default_rng(0)
    depths = rng.uniform(1000, 4000, (2, 64, 128)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)

    small = dict(SMALL, mesh_shape=(2,))
    small_state = jtrain.create_train_state(JaxConfig(**small), jax.random.PRNGKey(0), 10)
    imgs = rng.integers(0, 256, (8, 4, 40, 40, 3), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0, 0, 0, 1, 0], np.int32)
    key = jax.random.PRNGKey(7)
    aug = _jax_aug_params(key, 8, 4, 40, 40, 32, 32, False)

    # Two host batches: 8 tuples (divided over the ranks), then a tail of 5.
    tail_imgs = rng.integers(0, 256, (5, 4, 40, 40, 3), dtype=np.uint8)
    tail_batches = [(imgs, labels, [("a", "b", int(y)) for y in labels]),
                    (tail_imgs, labels[:5], [("a", "b", int(y)) for y in labels[:5]])]
    tail_key = jax.random.PRNGKey(11)
    r, tail_draws = tail_key, []
    for b in (8, 5):
        r, sub = jax.random.split(r)
        tail_draws.append(_jax_aug_params(sub, b, 4, 40, 40, 32, 32, False))

    corpus = root / "corpus"
    write_bev_tree(corpus, {TRAIN_IDS[0]: 4, TRAIN_IDS[1]: 2, VAL_ID: 2, TEST_ID: 4}, px=40)
    start = jtrain.save_checkpoint(str(root / "start"), _copy(small_state), 0, 0.0, JaxConfig(**small))
    run = dict(small, data_root=str(corpus))
    cli = root / "cli"
    _write_building(cli)
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    model.load_state_dict(_weights(tiny_state, 18), strict=True)
    torch.save(model.state_dict(), cli / "model.pt")
    cli_argv = ["--hypotheses_save_root", str(cli / "hyp"), "--raw_dataset_dir", str(cli / "zind"),
                "--depth_save_root", str(cli / "depth"), "--ckpt_fpath", str(cli / "model.pt"), "--num_layers", "18",
                "--resize_px", "64", "--crop_px", "56", "--device", "cpu"]
    return {
        "cli": cli, "cli_argv": cli_argv,
        "root": root, "tiny_state": tiny_state, "small_state": small_state, "key": key, "tail_key": tail_key,
        "run": run, "start": start,
        "port": {
            "tiny": TINY, "render": RENDER, "weights": _weights(tiny_state, 18), "depths": depths, "rgbs": rgbs,
            "hyps": _hyps(AlignmentHypothesis, Sim2), "batch": BATCH,
            "small": small, "weights_small": _weights(small_state, 18), "imgs": imgs, "labels": labels,
            "steps": [(False, aug), (True, aug)], "tail_batches": tail_batches, "tail_draws": tail_draws,
            "train_cfg": dict(run, model_save_dirpath=str(root / "port")), "train_draws": _jax_train_draws(0, 2, 2),
            "start_ckpt": start, "eval_dir": str(root / "port_preds"), "layouts": _layouts(),
        },
    }


@pytest.fixture(scope="module")
def worlds(inputs):
    """The two spawned groups, started side by side; salve_tpu runs here
    meanwhile (`refs`)."""
    from torch_parallel_work import world

    pool = concurrent.futures.ThreadPoolExecutor(3)
    world2 = dict(inputs["port"], parts=["score", "score_layout", "corpus", "train_steps", "train_and_evaluate"],
                  corpus_cases=CORPUS_CASES[2])
    world3 = {"parts": ["corpus"], "corpus_cases": CORPUS_CASES[3]}
    futures = {n: pool.submit(launch, world, n, w, device="cpu", num_threads=1, timeout_s=300)
               for n, w in ((2, world2), (3, world3))}
    # The CLI starts its own 2 ranks.
    futures["cli"] = pool.submit(test_fused.main, inputs["cli_argv"] + [
        "--batch_size", "2", "--serialization_save_dir", str(inputs["cli"] / "two"), "--mesh_devices", "2"])
    yield futures
    pool.shutdown(wait=True)


def _jax_train_eval(inputs, fn, *args):
    """salve_tpu's train() or evaluate() on its mesh of 2, reading pixels
    through the port's decoder (test_torch_training.py) in sorted order."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jloop, "make_mesh", lambda shape=None: _mesh(2))
        mp.setattr(jbp.BEVPairDataset, "_load_tuples", _decode_like_salve_tpu_native)
        mp.setattr(jbp, "make_dataset", listing_sorted_make_dataset)
        return fn(*args)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def refs(inputs, worlds):
    """salve_tpu on its mesh of 2, on every input the ranks see."""
    port, root, mesh = inputs["port"], inputs["root"], _mesh(2)
    out = {}
    with mesh:
        for mode in ("warp", "direct"):
            out[mode] = jax_score(inputs["tiny_state"], JaxConfig(**TINY), port["depths"], port["rgbs"],
                                  {3: 0, 5: 1}, _hyps(JaxHypothesis, JaxSim2), batch_size=BATCH,
                                  render_cfg=JaxRenderConfig(**RENDER), mesh=mesh, use_warp_renders=(mode == "warp"))
        steps = {b: jtrain.make_train_step(JaxConfig(**dict(port["small"], class_balanced_loss=b)))
                 for b in (False, True)}
        for balanced, step in steps.items():
            jstate = replicate(mesh, _copy(inputs["small_state"]))
            out[balanced] = step(jstate, *shard_batch(mesh, (port["imgs"], port["labels"])), inputs["key"])
        jstate = replicate(mesh, _copy(inputs["small_state"]))
        out["tail"] = jloop.run_epoch(JaxConfig(**port["small"]), 0, jstate, steps[False],
                                      HostBatches(port["tail_batches"]), "train", rng=inputs["tail_key"],
                                      mesh=mesh)
    run = inputs["run"]
    out["train"] = _jax_train_eval(inputs, jloop.train, JaxConfig(**dict(run, model_save_dirpath=str(root / "jax"))),
                                   0, None, inputs["start"])
    out["evaluate"] = _jax_train_eval(inputs, jloop.evaluate, JaxConfig(**run), inputs["start"], "test",
                                      str(root / "jax_preds"))
    return out


def _ranks(worlds, n):
    out = worlds[n].result(timeout=600)
    assert [o["rank"] for o in out] == list(range(n)) and {o["size"] for o in out} == {n}
    return out


# ---------------------------------------------------------------- the scorer


@pytest.mark.parametrize("mode", ["warp", "direct"])
def test_scorer_matches_salve_tpu_mesh(inputs, refs, worlds, mode):
    ref = refs[mode]
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    model.load_state_dict(inputs["port"]["weights"], strict=True)
    one = score_floor_hypotheses(model, TrainingConfig(**TINY), inputs["port"]["depths"], inputs["port"]["rgbs"],
                                 {3: 0, 5: 1}, _hyps(AlignmentHypothesis, Sim2), batch_size=BATCH,
                                 render_cfg=BEVRenderConfig(**RENDER), use_warp_renders=(mode == "warp"),
                                 device="cpu")
    ranks = _ranks(worlds, 2)
    got = ranks[0]["score"][mode]["results"]
    assert got == ranks[1]["score"][mode]["results"]
    assert len(got) == len(ref) == len(POSES)
    for g, r in zip(got, ref):
        assert g[:4] == (r.i1, r.i2, r.wdo_pair_uuid, r.configuration)
    assert [g[4] for g in got] == [r.y_hat for r in ref] == [o.y_hat for o in one]
    np.testing.assert_allclose([g[5] for g in got], [r.prob for r in ref], atol=1e-3, rtol=0)
    np.testing.assert_allclose([g[5] for g in got], [o.prob for o in one], rtol=1e-5)
    # Each rank's share of every padded batch is the one-device scorer's
    # output over those rows at the per-rank batch, bit for bit.
    k = BATCH // 2
    for rank in ranks:
        own = rank["score"][mode]["own_rows"]
        padded = []
        for s in range(0, len(POSES), BATCH):
            chunk = got[s : s + BATCH]
            padded += (chunk + [chunk[-1]] * (BATCH - len(chunk)))[rank["rank"] * k : (rank["rank"] + 1) * k]
        assert [o[4:] for o in own] == [p[4:] for p in padded][: len(own)]


def test_a_layout_verifier_on_the_mesh_draws_each_ranks_own_rows(worlds):
    """Each rank draws pano 2's bank and its own rows of every padded batch,
    and scores them as the one-device scorer scores those rows."""
    ranks = _ranks(worlds, 2)
    got = ranks[0]["score_layout"]["results"]
    assert got == ranks[1]["score_layout"]["results"] and len(got) == len(POSES)
    k = BATCH // 2
    for rank in ranks:
        own = rank["score_layout"]["own_rows"]
        padded = []
        for s in range(0, len(POSES), BATCH):
            chunk = got[s : s + BATCH]
            padded += (chunk + [chunk[-1]] * (BATCH - len(chunk)))[rank["rank"] * k : (rank["rank"] + 1) * k]
        assert [o[4:] for o in own] == [p[4:] for p in padded]
        assert rank["score_layout"]["rasters"] == 2 + k * -(-len(POSES) // BATCH)


def test_scorer_refuses_a_batch_the_mesh_does_not_divide(inputs, worlds):
    with pytest.raises(ValueError, match="not divisible") as ref:
        jax_score(inputs["tiny_state"], JaxConfig(**TINY), inputs["port"]["depths"], inputs["port"]["rgbs"],
                  {3: 0, 5: 1}, _hyps(JaxHypothesis, JaxSim2)[:1], batch_size=3,
                  render_cfg=JaxRenderConfig(**RENDER), mesh=_mesh(2))
    for rank in _ranks(worlds, 2):
        assert rank["score"]["not_divisible"] == str(ref.value)


# ---------------------------------------------------------------- the device corpus


@pytest.mark.parametrize("n", [2, 3])
def test_device_corpus_matches_salve_tpu_mesh(worlds, n):
    ranks = _ranks(worlds, n)
    for size, batch in CORPUS_CASES[n]:
        ref = jdc.DeviceCorpus(FakeDataset(JaxConfig(resize_h=6, resize_w=5), size), _mesh(n))
        shard, masked = -(-size // n), 0
        assert [r["corpus"][(size, "shard_rows")] for r in ranks] == [shard] * n
        for shuffle, seed in ((True, 0), (True, 5), (False, 0)):
            rb = list(ref.iter_batches(batch, shuffle=shuffle, seed=seed))
            gbs = [r["corpus"][(size, batch, shuffle, seed)] for r in ranks]
            assert all(len(gb) == len(rb) == shard // (batch // n) for gb in gbs)
            for t, (ri, rl, rt, rv) in enumerate(rb):
                imgs = np.concatenate([gb[t][0] for gb in gbs])
                np.testing.assert_array_equal(imgs, np.asarray(ri))
                for gb in gbs:
                    np.testing.assert_array_equal(gb[t][1], rl)
                    assert gb[t][2] == rt
                    np.testing.assert_array_equal(gb[t][3], rv)
            masked += sum(int((~v).sum()) for _, _, _, v in rb)
        # The wrap-around padding rows show, masked, where the corpus is padded.
        assert (masked > 0) == (size % n > 0), (size, masked)
    with pytest.raises(ValueError) as not_div:
        next(ref.iter_batches(n + 1, shuffle=False))
    with pytest.raises(ValueError) as too_small:
        next(ref.iter_batches(n * (ref.shard_size + 1), shuffle=False))
    for r in ranks:
        assert r["corpus"]["not_divisible"] == str(not_div.value)
        assert r["corpus"]["too_small"] == str(too_small.value)


# ---------------------------------------------------------------- training


def _as_state(out: dict, cfg: TrainingConfig) -> ttrain.TrainState:
    state = ttrain.create_train_state(cfg, torch.Generator().manual_seed(1), 10, CPU)
    state.model.load_state_dict(out["model"], strict=True)
    for name, p in state.model.named_parameters():
        p.grad = out["grads"][name]
    names = state.param_names()
    state.optimizer.mu = [out["mu"][n] for n in names]
    state.optimizer.nu = [out["nu"][n] for n in names]
    state.step = out["step"]
    return state


def _bits_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[part][k], b[part][k]) for part in ("model", "grads", "mu", "nu") for k in a[part])


@pytest.mark.parametrize("balanced", [False, True], ids=["ce", "class_balanced_ce"])
def test_one_train_step_matches_salve_tpu_mesh(inputs, refs, worlds, balanced):
    port = inputs["port"]
    jstate1, jm = refs[balanced]
    ranks = _ranks(worlds, 2)
    got = [r["train_steps"][balanced] for r in ranks]
    assert _bits_equal(got[0]["state"], got[1]["state"])
    g = got[0]
    assert abs(g["loss"] - float(jm["loss"])) <= 1e-5
    assert g["accuracy"] == float(jm["accuracy"])
    assert float((g["probs"] - torch.from_numpy(np.array(jm["probs"]))).abs().max()) <= 1e-5
    assert g["state"]["step"] == g["state"]["count"] == int(jstate1.step) == 1
    cfg = TrainingConfig(**dict(port["small"], class_balanced_loss=balanced))
    _compare_step(_as_state(g["state"], cfg), port["weights_small"], jstate1)


def test_tail_batch_runs_whole_on_every_rank(inputs, refs, worlds):
    """salve_tpu's loop shards the batch of 8 and runs the batch of 5
    unsharded (salve_tpu/training/loop.py:123); the port splits the first
    and runs the second whole on both ranks, with no collective."""
    jstate2, jmetrics = refs["tail"]
    got = [r["train_steps"]["tail"] for r in _ranks(worlds, 2)]
    assert got[0]["draws_left"] == got[1]["draws_left"] == 0
    assert _bits_equal(got[0]["state"], got[1]["state"])
    assert got[0]["metrics"]["mAcc"] == jmetrics["mAcc"]
    assert got[0]["metrics"]["class_accs"] == jmetrics["class_accs"]
    # The second step starts from states one Adam step apart (about lr where
    # g is tiny), so the epoch's loss is held as train()'s losses are, and
    # the running statistics and parameters at lr's scale.
    np.testing.assert_allclose(got[0]["metrics"]["avg_loss"], jmetrics["avg_loss"], rtol=1e-3)
    tstate = _as_state(got[0]["state"], TrainingConfig(**inputs["port"]["small"]))
    assert tstate.step == int(jstate2.step) == 2
    stats = jax.tree_util.tree_map(np.asarray, jstate2.batch_stats)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate2.params), stats, 18)
    for k, v in tstate.model.state_dict().items():
        if "running" in k:
            assert float((v - ref[k]).abs().max()) <= 1e-3, k
    for name, p in tstate.model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= 2 * 1e-3, name


def test_train_matches_salve_tpu_mesh(inputs, refs, worlds):
    ref = refs["train"]
    got = [r["train_and_evaluate"] for r in _ranks(worlds, 2)]
    assert got[0]["results"] == got[1]["results"]
    assert got[0]["draws_left"] == got[1]["draws_left"] == 0
    assert sorted(got[0]["results"]) == sorted(ref)
    for k in ref:
        assert len(got[0]["results"][k]) == len(ref[k]) == 2, k
    for k in ("train_avg_loss", "val_avg_loss"):
        np.testing.assert_allclose(got[0]["results"][k], ref[k], rtol=1e-3, err_msg=k)
    # Rank 0 writes the checkpoint, the results JSONs and (evaluate) the
    # batch files; rank 1 writes nothing.
    assert got[1]["writes"] == [] and "save_checkpoint" in got[0]["writes"]
    port_dir, = glob.glob(f"{inputs['root'] / 'port'}/*/")
    assert Path(port_dir, "train_ckpt.pt").exists() and Path(port_dir, "results-fields.json").exists()


def test_evaluate_matches_salve_tpu_mesh(inputs, refs, worlds):
    ranks = _ranks(worlds, 2)
    assert ranks[0]["train_and_evaluate"]["evaluate"] == ranks[1]["train_and_evaluate"]["evaluate"]
    np.testing.assert_allclose(ranks[0]["train_and_evaluate"]["evaluate"], refs["evaluate"], rtol=1e-6)
    got_files = sorted(Path(inputs["port"]["eval_dir"]).glob("batch_*.json"))
    ref_files = sorted((inputs["root"] / "jax_preds").glob("batch_*.json"))
    assert [f.name for f in got_files] == [f.name for f in ref_files] == ["batch_0.json", "batch_1.json"]
    for g, r in zip(got_files, ref_files):
        g, r = json.loads(g.read_text()), json.loads(r.read_text())
        for k in ("y_hat", "y_true", "fp0", "fp1"):
            assert g[k] == r[k], k
        np.testing.assert_allclose(g["y_hat_probs"], r["y_hat_probs"], atol=1e-4)


# ---------------------------------------------------------------- the CLI


def test_mesh_devices_cli_writes_the_world_of_one_files(inputs, worlds):
    """`--mesh_devices 2 --device cpu` starts 2 gloo ranks; rank 0 writes
    the batch files of the run without the flag."""
    cli, argv = inputs["cli"], inputs["cli_argv"]
    test_fused.main(argv + ["--batch_size", "2", "--serialization_save_dir", str(cli / "one")])
    worlds["cli"].result(timeout=600)
    one, two = _read_batches(cli / "one"), _read_batches(cli / "two")
    assert sorted(p.name for p in (cli / "two").iterdir()) == ["batch_0.json", "batch_1.json"]
    for k in ("y_hat", "y_true", "fp0", "fp1"):
        assert two[k] == one[k], k
    np.testing.assert_allclose(two["y_hat_probs"], one["y_hat_probs"], rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        test_fused.main(argv + ["--batch_size", "3", "--serialization_save_dir", str(cli / "three"),
                                "--mesh_devices", "2"])
