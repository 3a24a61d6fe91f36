"""The port's verifier training against salve_tpu's, one step at a time, on the CPU.

ResNet-18, float32, resize 40 / crop 32, batch 8, one device on each side
(mesh_shape (1,)). The RNG streams of torch and JAX cannot match, so every
comparison gives both sides the same weights (carried by
`state_dict_from_flax`, or read from salve_tpu's own `train_ckpt.flax`) and
the augmentation parameters JAX draws (test_torch_bev_pairs._jax_aug_params).

  * (f) initializers: per tensor the Flax draw's shape, zero batch-norm
    scales in the same places, std within 10%;
  * (g) one train step, plain and class-balanced CE: the loss within 1e-5,
    each gradient within 1e-4 of its tensor's largest magnitude, batch_stats
    within 1e-5, params within 1e-6 where |g| > 1e-3 max|g| and within
    2 lr elsewhere (the first Adam step is lr * g / (|g| + eps), about
    +-lr where g is tiny, so a rounding-level difference in g can flip it);
    the Adam moments within 1e-6 of their largest magnitude given the same
    gradients (`test_optimizer_equals_optax`; through a whole step they
    inherit the gradients' float32 difference, measured at 5.5e-6, so there
    they are held to the gradients' bound);
  * resuming from salve_tpu's `train_ckpt.flax` restores its state bit for
    bit, and one more step lands where salve_tpu's does: (g)'s bounds, but
    params within lr * 1e-2 where |g| > 1e-3 max|g| (a second Adam step is
    no longer +-lr: it follows the gradients' relative difference);
  * (h) the poly LR equals optax's schedule at every count to max_iter + 2;
  * (i) `train()` for 2 epochs of 2 steps: the same results keys and
    lengths, losses within 1e-3 relative, the checkpoint and meta files;
    `resume_from` with `finetune_from` raises;
  * (j) `evaluate` writes batch_{i}.json: y_hat, y_true, fp0, fp1 equal,
    y_hat_probs within 1e-4;
  * (k) the training policy: `deterministic_algorithms()` sets its three
    flags and restores them, also when the block raises; `train()`,
    `evaluate()` and the depth step run under it; two runs of 2 steps from
    one state, batch and augmentation seed give equal parameters, batch-norm
    statistics and Adam moments, bit for bit.

Pixels reach salve_tpu's loop through the port's decoder, which equals
salve_tpu's native loader byte for byte (test_torch_bev_pairs.py): its own
loader would build native/libjpeg_loader.so inside the checkout, which
concurrent test workers race on.
"""

import copy
import glob
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from salve_tpu.dataset import bev_pairs as jbp
from salve_tpu.parallel.mesh import make_mesh
from salve_tpu.training import loop as jloop
from salve_tpu.training import train as jtrain
from salve_tpu.training.config import TrainingConfig as JaxConfig
from salve_tpu_torch.device import deterministic_algorithms
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet, init_flax_style
from salve_tpu_torch.models.weights import state_dict_from_flax
from salve_tpu_torch.native.jpeg import decode_resize_batch
from salve_tpu_torch.training import loop as tloop
from salve_tpu_torch.training import train as ttrain
from salve_tpu_torch.training import transforms as tt
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.training.flax_checkpoint import _param_names, flax_checkpoint_to_port
from test_torch_bev_pairs import (TEST_ID, TRAIN_IDS, VAL_ID, _jax_aug_params, listing_sorted_make_dataset,
                                  write_bev_tree)

CPU = torch.device("cpu")
SMALL = dict(num_layers=18, resize_h=40, resize_w=40, train_h=32, train_w=32, batch_size=8,
             compute_dtype="float32", mesh_shape=(1,), num_epochs=2, workers=2, print_every=1)


def _copy(state):
    """A copy of a JAX TrainState (the jitted step donates its argument)."""
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def _port_state(cfg: TrainingConfig, jstate, max_iter: int) -> ttrain.TrainState:
    state = ttrain.create_train_state(cfg, torch.Generator().manual_seed(1), max_iter, CPU)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    state.model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), stats,
                                                     cfg.num_layers), strict=True)
    return state


@pytest.fixture(scope="module")
def jax_state():
    return jtrain.create_train_state(JaxConfig(**SMALL), jax.random.PRNGKey(0), 10)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (8, 4, 40, 40, 3), dtype=np.uint8)
    return imgs, np.array([0, 1, 1, 0, 0, 0, 1, 0], np.int32)


# ---------------------------------------------------------------- (f) initializers


_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@pytest.mark.parametrize("num_layers,n_blocks", [(18, 8), (50, 16)])
def test_initializers_match_flax(jax_state, num_layers, n_blocks):
    """Flax's draw (salve_tpu/models/resnet.py, basic and bottleneck blocks)
    against init_flax_style's, tensor by tensor."""
    from salve_tpu.models.early_fusion import EarlyFusionCEResnet as FlaxModel

    if num_layers == 18:
        variables = {"params": jax_state.params, "batch_stats": jax_state.batch_stats}
    else:
        flax_model = FlaxModel(num_layers=num_layers, compute_dtype=jnp.float32)
        variables = jax.jit(lambda k: flax_model.init(k, [jnp.zeros((1, 32, 32, 3))] * 4))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    ref = state_dict_from_flax(variables["params"], variables["batch_stats"], num_layers)
    model = init_flax_style(EarlyFusionCEResnet(num_layers=num_layers, compute_dtype="float32"),
                            torch.Generator().manual_seed(3))
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    zero_scales = []
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if k.endswith("num_batches_tracked"):
            continue
        if g.ndim == 1:
            # Batch norm and the head's bias are constants: equal.
            assert torch.equal(g, r), k
            if k.endswith(".weight") and not r.any():
                zero_scales.append(k)
            continue
        rs, gs = float(r.std()), float(g.std())
        assert abs(gs - rs) <= 0.1 * rs, (k, gs, rs)
        # Truncated at 2 sigma of the untruncated normal, as jax's draw.
        max_z = float(g.abs().max()) * _TRUNC_STD * np.sqrt(r[0].numel())
        assert max_z <= 2.0 + 1e-5 and (g.numel() < 2000 or max_z > 1.95), k
    assert len(zero_scales) == n_blocks  # the last BN of each residual branch
    assert all(k.endswith("bn2.weight" if num_layers == 18 else "bn3.weight") for k in zero_scales)


# ---------------------------------------------------------------- (g) one train step


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = max(float(a.abs().max()), float(b.abs().max()))
    return float((a.double() - b.double()).abs().max()) / scale if scale > 0 else 0.0


def _compare_step(tstate, p0, jstate1, grads_ref=None, param_tol=1e-6):
    """(g)'s bounds between the port's state after a step and salve_tpu's."""
    opt = jstate1.opt_state[1][0]
    stats = jax.tree_util.tree_map(np.asarray, jstate1.batch_stats)
    mu = _param_names(jax.tree_util.tree_map(np.asarray, opt.mu), 18, stats)
    nu = _param_names(jax.tree_util.tree_map(np.asarray, opt.nu), 18, stats)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate1.params), stats, 18)
    got = tstate.model.state_dict()
    for k in got:
        if "running" in k:
            assert float((got[k] - ref[k]).abs().max()) <= 1e-5, k
    lr = 1e-3
    for i, (name, p) in enumerate(tstate.model.named_parameters()):
        # salve_tpu's gradient, read back from its first moment:
        # mu = (1 - b1) * (g + wd * p0) after the first step.
        g_ref = grads_ref[name] if grads_ref is not None else mu[name].double() / 0.1 - 1e-4 * p0[name].double()
        g = p.grad
        # 1e-9: the read-back's own rounding (about 1e-7 of |mu| / 0.1) where
        # the gradient is exactly 0 (a branch behind a zero-init BN scale).
        assert float((g.double() - g_ref).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-9, name
        assert _max_rel(tstate.optimizer.mu[i], mu[name]) <= 1e-4, name
        assert _max_rel(tstate.optimizer.nu[i], nu[name]) <= 1e-4, name
        d = (p.detach() - ref[name]).abs()
        big = g.abs() > 1e-3 * g.abs().max()
        assert not big.any() or float(d[big].max()) <= param_tol, name
        assert float(d.max()) <= 2 * lr, name


@pytest.mark.parametrize("balanced", [False, True], ids=["ce", "class_balanced_ce"])
def test_one_train_step_matches_salve_tpu(jax_state, batch, balanced):
    imgs, labels = batch
    kw = dict(SMALL, class_balanced_loss=balanced)
    jcfg, tcfg = JaxConfig(**kw), TrainingConfig(**kw)
    key = jax.random.PRNGKey(7)
    jstate1, jm = jtrain.make_train_step(jcfg)(_copy(jax_state), jnp.asarray(imgs), jnp.asarray(labels), key)

    tstate = _port_state(tcfg, jax_state, 10)
    p0 = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    tstate, tm = ttrain.make_train_step(tcfg)(tstate, imgs, labels, _jax_aug_params(key, 8, 4, 40, 40, 32, 32, False))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert float((tm["probs"] - torch.from_numpy(np.array(jm["probs"]))).abs().max()) <= 1e-5
    assert tstate.step == int(jstate1.step) == 1
    assert tstate.optimizer.count == int(jstate1.opt_state[1][0].count) == 1
    _compare_step(tstate, p0, jstate1)


def test_bf16_bottleneck_step_matches_salve_tpu(batch):
    """The released config's training arithmetic at small width: ResNet-50
    (bottleneck blocks) under bf16 autocast, one step from the same weights
    and draws as salve_tpu's bf16 step.

    Against salve_tpu the bounds are bf16-level: the two sides' bf16
    convolutions round different float32 sums, so a bf16 ulp (2^-8
    relative) flips here and there and spreads through 50 layers. The loss
    is held within 2^-6 of its value and each running statistic within 2^-5
    of its tensor's largest magnitude (measured 2.8e-3 and 6.7e-3). The
    batch norm itself is held at a float32-level bound: every running
    statistic equals 0.9 ra + 0.1 stat, stat being the float64 mean and
    biased variance of the bf16 activation that batch norm received,
    within 1e-6 of its tensor's largest magnitude (measured 1.1e-7; bf16
    statistics would be about 4e-3 off)."""
    from salve_tpu_torch.models.resnet import FlaxBatchNorm2d

    imgs, labels = batch
    kw = dict(SMALL, num_layers=50, compute_dtype="bfloat16")
    jcfg, tcfg = JaxConfig(**kw), TrainingConfig(**kw)
    jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(0), 10)
    key = jax.random.PRNGKey(7)
    jstate1, jm = jtrain.make_train_step(jcfg)(_copy(jstate), jnp.asarray(imgs), jnp.asarray(labels), key)

    tstate = _port_state(tcfg, jstate, 10)
    init = {k: v.clone() for k, v in tstate.model.state_dict().items() if "running" in k}
    seen = {}
    hooks = [m.register_forward_hook(lambda m, a, out, n=n: seen.__setitem__(n, (a[0].detach(), out.dtype)))
             for n, m in tstate.model.named_modules() if isinstance(m, FlaxBatchNorm2d)]
    try:
        tstate, tm = ttrain.make_train_step(tcfg)(tstate, imgs, labels,
                                                  _jax_aug_params(key, 8, 4, 40, 40, 32, 32, False))
    finally:
        for h in hooks:
            h.remove()

    loss = float(jm["loss"])
    assert abs(float(tm["loss"]) - loss) <= 2.0 ** -6 * loss
    stats = jax.tree_util.tree_map(np.asarray, jstate1.batch_stats)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate1.params), stats, 50)
    got = tstate.model.state_dict()
    assert len(seen) == sum(k.endswith("running_mean") for k in got) == 53
    for name, (x, out_dtype) in seen.items():
        assert x.dtype == out_dtype == torch.bfloat16, name
        x = x.double()
        want = {"running_mean": 0.9 * init[f"{name}.running_mean"].double() + 0.1 * x.mean(dim=(0, 2, 3)),
                "running_var": 0.9 * init[f"{name}.running_var"].double()
                + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)}
        for leaf, w in want.items():
            k = f"{name}.{leaf}"
            assert got[k].dtype == torch.float32, k
            assert _max_rel(got[k], w) <= 1e-6, k
            assert _max_rel(got[k], ref[k]) <= 2.0 ** -5, k


def test_resume_from_salve_tpu_flax_then_step(jax_state, batch, tmp_path):
    """salve_tpu saves after one step; the port restores that `.flax` bit
    for bit (no flax, no msgpack), and one more step on both sides lands in
    (g)'s bounds."""
    imgs, labels = batch
    jcfg, tcfg = JaxConfig(**SMALL), TrainingConfig(**SMALL)
    step = jtrain.make_train_step(jcfg)
    jstate1, _ = step(_copy(jax_state), jnp.asarray(imgs), jnp.asarray(labels), jax.random.PRNGKey(7))
    ckpt = jtrain.save_checkpoint(str(tmp_path), jstate1, 0, 0.5, jcfg)
    read = flax_checkpoint_to_port(ckpt, 18)
    assert (read["step"], read["opt_state"]["count"], read["opt_state"]["schedule_count"]) == (1, 1, 1)

    tstate = ttrain.load_model_checkpoint(ckpt, ttrain.create_train_state(
        tcfg, torch.Generator().manual_seed(2), 10, CPU))
    assert tstate.step == 1 and tstate.optimizer.count == 1 and tstate.optimizer.schedule_count == 1
    opt = jstate1.opt_state[1][0]
    flat_stats = jax.tree_util.tree_map(np.asarray, jstate1.batch_stats)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate1.params), flat_stats, 18)
    for k, v in tstate.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    for name, mu, nu in zip(tstate.param_names(), tstate.optimizer.mu, tstate.optimizer.nu):
        assert torch.equal(mu, _param_names(jax.tree_util.tree_map(np.asarray, opt.mu), 18, flat_stats)[name])
        assert torch.equal(nu, _param_names(jax.tree_util.tree_map(np.asarray, opt.nu), 18, flat_stats)[name])

    # One more step on each side: salve_tpu's gradient of this step taken
    # from the change of its first moment, mu2 = b1 mu1 + (1 - b1)(g + wd p1).
    imgs2 = np.ascontiguousarray(imgs[::-1])
    key2 = jax.random.PRNGKey(8)
    mu1 = {n: t.clone() for n, t in zip(tstate.param_names(), tstate.optimizer.mu)}
    p1 = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    jstate2, jm = step(jstate1, jnp.asarray(imgs2), jnp.asarray(labels), key2)
    tstate, tm = ttrain.make_train_step(tcfg)(tstate, imgs2, labels, _jax_aug_params(key2, 8, 4, 40, 40, 32, 32, False))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    stats2 = jax.tree_util.tree_map(np.asarray, jstate2.batch_stats)
    mu2 = _param_names(jax.tree_util.tree_map(np.asarray, jstate2.opt_state[1][0].mu), 18, stats2)
    grads_ref = {n: (mu2[n].double() - 0.9 * mu1[n].double()) / 0.1 - 1e-4 * p1[n].double() for n in mu1}
    # A second Adam step moves p by lr * mu_hat / sqrt(nu_hat), which follows
    # the gradient's relative difference (under 1e-2 where |g| > 1e-3 max|g|,
    # the gradients agreeing within 1e-5 of max|g|): lr * 1e-2 there.
    _compare_step(tstate, p1, jstate2, grads_ref=grads_ref, param_tol=1e-5)
    assert tstate.step == int(jstate2.step) == 2


def test_optimizer_equals_optax():
    """Given the same gradients, three steps of the port's Adam land on
    optax's chain(add_decayed_weights, adam(poly schedule)), jitted as
    salve_tpu's train step runs it: mu and nu within 1e-6 of each tensor's
    largest magnitude (elementwise, g + wd * p can cancel to a few ulps),
    params within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = [(64, 12, 7, 7), (64,), (2, 512)]
    params = [rng.normal(0, 0.05, s).astype(np.float32) for s in shapes]
    cfg = TrainingConfig()
    tx = optax.chain(optax.add_decayed_weights(cfg.weight_decay),
                     optax.adam(optax.polynomial_schedule(cfg.base_lr, 0.0, cfg.poly_lr_power, 5)))
    update = jax.jit(tx.update)
    jp = [jnp.asarray(p) for p in params]
    jopt = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ttrain.OptaxAdam(tp, cfg.weight_decay, ttrain.make_poly_schedule(cfg, 5))
    for _ in range(3):
        grads = [rng.normal(0, 10.0 ** -rng.integers(1, 6), s).astype(np.float32) for s in shapes]
        updates, jopt = update([jnp.asarray(g) for g in grads], jopt, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for i in range(len(shapes)):
            assert _max_rel(opt.mu[i], torch.from_numpy(np.array(jopt[1][0].mu[i]))) <= 1e-6
            assert _max_rel(opt.nu[i], torch.from_numpy(np.array(jopt[1][0].nu[i]))) <= 1e-6
            assert float((tp[i].detach() - torch.from_numpy(np.array(jp[i]))).abs().max()) <= 1e-6
        assert opt.count == int(jopt[1][0].count) and opt.schedule_count == int(jopt[1][1].count)


# ---------------------------------------------------------------- (h) the poly LR


@pytest.mark.parametrize("max_iter,power,base_lr", [(1, 0.9, 1e-3), (2, 0.9, 1e-3), (10, 0.9, 1e-3),
                                                    (100, 0.9, 1e-3), (37, 0.5, 3e-4), (4, 2.0, 0.01)])
def test_poly_schedule_equals_optax(max_iter, power, base_lr):
    """Bit for bit against optax's schedule evaluated eagerly in float32,
    the clamp past max_iter included (there lr is 0). Under jax.jit, XLA:CPU
    reads it 1 ulp off at some counts (ROADMAP §C)."""
    cfg = TrainingConfig(base_lr=base_lr, poly_lr_power=power)
    ours = ttrain.make_poly_schedule(cfg, max_iter)
    theirs = jtrain.make_poly_schedule(JaxConfig(base_lr=base_lr, poly_lr_power=power), max_iter)
    for count in range(max_iter + 3):
        assert np.float32(ours(count)) == np.float32(theirs(jnp.int32(count))), count
    assert ours(max_iter + 2) == 0.0


# ---------------------------------------------------------------- (i) train() and (j) evaluate


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    # 16 train tuples (2 full batches of 8), 6 val, 10 test (batches of 8 and 2).
    write_bev_tree(root, {TRAIN_IDS[0]: 4, TRAIN_IDS[1]: 2, VAL_ID: 2, TEST_ID: 4}, px=40)
    return root


def _decode_like_salve_tpu_native(self, tuples):
    flat = [fp for t in tuples for fp in t[:-1]]
    imgs = decode_resize_batch(flat, self.args.resize_h, self.args.resize_w)
    return imgs.reshape(len(tuples), len(tuples[0]) - 1, self.args.resize_h, self.args.resize_w, 3)


def _one_jax_device(mp: pytest.MonkeyPatch) -> None:
    """salve_tpu's loop on a mesh of one device, as the port runs on one
    card (tests/conftest.py gives JAX 8 CPU devices; over 8, its batch
    sums run in another order and its losses move by up to 4e-3 after four
    steps)."""
    mp.setattr(jloop, "make_mesh", lambda shape=None: make_mesh((1,), devices=jax.devices()[:1]))


def _jax_train_draws(seed: int, n_epochs: int, steps: int):
    """The augmentation parameters salve_tpu's train() draws, in order
    (loop.py:189-190, 296-297, 106-107)."""
    rng = jax.random.PRNGKey(seed)
    rng, _ = jax.random.split(rng)
    draws = []
    for _ in range(n_epochs):
        rng, epoch_rng = jax.random.split(rng)
        r = epoch_rng
        for _ in range(steps):
            r, sub = jax.random.split(r)
            draws.append(_jax_aug_params(sub, 8, 4, 40, 40, 32, 32, False))
    return draws


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory, jax_state):
    """salve_tpu's and the port's train() from one salve_tpu `.flax` (step
    0), on the same batches and augmentation draws."""
    out = tmp_path_factory.mktemp("runs")
    start = jtrain.save_checkpoint(str(out / "start"), _copy(jax_state), 0, 0.0, JaxConfig(**SMALL))
    run = dict(SMALL, data_root=str(corpus))
    jcfg = JaxConfig(**dict(run, model_save_dirpath=str(out / "jax")))
    tcfg = TrainingConfig(**dict(run, model_save_dirpath=str(out / "port")))
    mp = pytest.MonkeyPatch()
    try:
        _one_jax_device(mp)
        mp.setattr(jbp.BEVPairDataset, "_load_tuples", _decode_like_salve_tpu_native)
        mp.setattr(jbp, "make_dataset", listing_sorted_make_dataset)
        ref = jloop.train(jcfg, seed=0, resume_from=start)
        draws = _jax_train_draws(0, 2, 2)
        mp.setattr(tt, "draw_augment_params", lambda *a, **k: draws.pop(0))
        got = tloop.train(tcfg, seed=0, resume_from=start, device="cpu")
        assert not draws
    finally:
        mp.undo()
    return {"ref": ref, "got": got, "jcfg": jcfg, "tcfg": tcfg, "out": out}


def test_train_matches_salve_tpu(trained):
    ref, got = trained["ref"], trained["got"]
    assert sorted(got) == sorted(ref) == sorted(
        f"{s}_{k}" for s in ("train", "val") for k in ("avg_loss", "mAcc", "class_accs"))
    for k in ref:
        assert len(got[k]) == len(ref[k]) == 2, k
    for k in ("train_avg_loss", "val_avg_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    assert np.all(np.isfinite(got["train_avg_loss"]))


def test_train_writes_checkpoint_meta_and_results(trained):
    port_dir, = glob.glob(f"{trained['tcfg'].model_save_dirpath}/*/")
    jax_dir, = glob.glob(f"{trained['jcfg'].model_save_dirpath}/*/")
    assert Path(port_dir, "train_ckpt.pt").exists() and not Path(port_dir, "train_ckpt.pt.tmp").exists()
    for name in ("train_ckpt.meta.json", "results-fields.json", "config.json"):
        ours, theirs = json.loads(Path(port_dir, name).read_text()), json.loads(Path(jax_dir, name).read_text())
        if name == "config.json":
            ours.pop("model_save_dirpath"), theirs.pop("model_save_dirpath")
        if name == "results-fields.json":
            assert sorted(ours) == sorted(theirs)
            continue
        if name == "train_ckpt.meta.json":
            ours.pop("val_mAcc"), theirs.pop("val_mAcc")
        assert ours == theirs, name
    assert len(glob.glob(f"{port_dir}/results-*-{trained['tcfg'].cfg_stem}.json")) == 1
    # The saved checkpoint reloads into a fresh state bit for bit.
    state = ttrain.create_train_state(trained["tcfg"], torch.Generator().manual_seed(5), 4, CPU)
    payload = torch.load(Path(port_dir, "train_ckpt.pt"), weights_only=False)
    state = ttrain.load_model_checkpoint(str(Path(port_dir, "train_ckpt.pt")), state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    assert state.step == payload["step"] > 0


def test_resume_and_finetune_are_exclusive(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        tloop.train(TrainingConfig(**SMALL), resume_from="a", finetune_from="b", device="cpu")
    with pytest.raises(ValueError, match="one card"):
        tloop.train(TrainingConfig(**dict(SMALL, mesh_shape=(4,))), device="cpu")


def test_finetune_restores_weights_only(trained, tmp_path):
    port_ckpt, = glob.glob(f"{trained['tcfg'].model_save_dirpath}/*/train_ckpt.pt")
    state = ttrain.create_train_state(trained["tcfg"], torch.Generator().manual_seed(5), 4, CPU)
    state = ttrain.load_model_checkpoint(port_ckpt, state, params_only=True)
    assert state.step == 0 and state.optimizer.count == 0
    assert all(not m.any() for m in state.optimizer.mu)


def test_evaluate_matches_salve_tpu(trained, corpus, tmp_path):
    """Both evaluate salve_tpu's best checkpoint of its run on the test split."""
    ckpt, = glob.glob(f"{trained['jcfg'].model_save_dirpath}/*/train_ckpt.flax")
    mp = pytest.MonkeyPatch()
    try:
        _one_jax_device(mp)
        mp.setattr(jbp.BEVPairDataset, "_load_tuples", _decode_like_salve_tpu_native)
        mp.setattr(jbp, "make_dataset", listing_sorted_make_dataset)
        ref = jloop.evaluate(trained["jcfg"], ckpt, "test", str(tmp_path / "jax"))
    finally:
        mp.undo()
    got = tloop.evaluate(trained["tcfg"], ckpt, "test", str(tmp_path / "port"), device="cpu")
    assert got == pytest.approx(ref, abs=1e-12)
    files = sorted(p.name for p in (tmp_path / "jax").glob("batch_*.json"))
    assert files == sorted(p.name for p in (tmp_path / "port").glob("batch_*.json")) == ["batch_0.json", "batch_1.json"]
    for name in files:
        r = json.loads((tmp_path / "jax" / name).read_text())
        g = json.loads((tmp_path / "port" / name).read_text())
        assert sorted(g) == sorted(r) == ["fp0", "fp1", "y_hat", "y_hat_probs", "y_true"]
        for k in ("y_hat", "y_true", "fp0", "fp1"):
            assert g[k] == r[k], k
        np.testing.assert_allclose(g["y_hat_probs"], r["y_hat_probs"], atol=1e-4)
    # The port's own checkpoint evaluates too, through the CLI.
    from salve_tpu_torch.cli import test as test_cli

    port_ckpt, = glob.glob(f"{trained['tcfg'].model_save_dirpath}/*/train_ckpt.pt")
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text("TrainingConfig:\n" + "".join(
        f"    {k}: {v}\n" for k, v in dict(SMALL, mesh_shape=None).items() if v is not None))
    test_cli.main(["--config_fpath", str(cfg_file), "--ckpt_fpath", port_ckpt, "--data_root", str(corpus),
                   "--serialization_save_dir", str(tmp_path / "cli"), "--device", "cpu", "--split", "val"])
    assert sorted(p.name for p in (tmp_path / "cli").glob("batch_*.json")) == ["batch_0.json"]


# ---------------------------------------------------------------- (k) the deterministic policy

POLICY = (True, False, True, False)


def _flags():
    return (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


def test_deterministic_algorithms_sets_and_restores_flags():
    before = _flags()
    with deterministic_algorithms():
        assert _flags() == POLICY
        with deterministic_algorithms():
            assert _flags() == POLICY
        assert _flags() == POLICY
    assert _flags() == before
    # Other settings come back too, also when the block raises.
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = True
    try:
        with pytest.raises(ValueError, match="inside"):
            with deterministic_algorithms():
                assert _flags() == POLICY
                raise ValueError("inside")
        assert _flags() == (True, True, before[2], True)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2], before[3]
    assert _flags() == before


def test_training_entry_points_run_under_the_policy(monkeypatch, tmp_path):
    """train(), evaluate() and the depth step set the policy before they
    touch the device, and leave the flags as they found them."""
    from salve_tpu_torch.training import depth as tdepth

    seen, before = [], _flags()

    def record(*args, **kwargs):
        seen.append(_flags())
        raise RuntimeError("recorded")

    state = tdepth.create_depth_train_state(torch.Generator().manual_seed(0), num_layers=18, input_hw=(32, 64),
                                            embed_dim=32, num_blocks=1, device="cpu")
    monkeypatch.setattr(tloop, "resolve_device", record)
    monkeypatch.setattr(tdepth, "depth_loss", record)
    zeros = np.zeros((1, 32, 64), np.float32)
    calls = [lambda: tloop.train(TrainingConfig(**SMALL)),
             lambda: tloop.evaluate(TrainingConfig(**SMALL), str(tmp_path / "c.pt"), "test", str(tmp_path)),
             lambda: tdepth.make_depth_train_step()(state, zeros[..., None].repeat(3, -1), zeros, zeros)]
    for call in calls:
        with pytest.raises(RuntimeError, match="recorded"):
            call()
    assert seen == [POLICY] * 3 and _flags() == before


def test_two_runs_from_one_state_are_bit_equal(batch):
    """Two runs of 2 small-width steps from one state, one batch and one
    augmentation seed, under the policy: the parameters, batch-norm
    statistics and Adam moments are equal bit for bit. The state is made
    once and copied: both runs start from the same bits."""
    imgs, labels = batch
    cfg = TrainingConfig(**SMALL)
    state0 = ttrain.create_train_state(cfg, torch.Generator().manual_seed(3), 10, CPU)
    step = ttrain.make_train_step(cfg)
    runs = []
    for _ in range(2):
        state, gen = copy.deepcopy(state0), torch.Generator().manual_seed(5)
        with deterministic_algorithms():
            for _ in range(2):
                state, _ = step(state, imgs, labels, gen)
        opt = state.optimizer.state_dict(state.param_names())
        runs.append(({k: v.clone() for k, v in state.model.state_dict().items()}, opt))
    (model_a, opt_a), (model_b, opt_b) = runs
    assert model_a.keys() == model_b.keys()
    assert [k for k in model_a if not torch.equal(model_a[k], model_b[k])] == []
    assert (opt_a["count"], opt_a["schedule_count"]) == (opt_b["count"], opt_b["schedule_count"]) == (2, 2)
    for moment in ("mu", "nu"):
        assert [k for k in opt_a[moment] if not torch.equal(opt_a[moment][k], opt_b[moment][k])] == []
    # The steps trained: the check compares moved weights.
    start = state0.model.state_dict()
    assert not torch.equal(model_a["conv1.weight"], start["conv1.weight"])
    assert not torch.equal(model_a["resnet.bn1.running_mean"], start["resnet.bn1.running_mean"])

