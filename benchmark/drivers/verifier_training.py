"""Driver `verifier_training`: the released recipe's train steps on a device corpus.

The program under test is the port's training loop as `training/loop.py:
train` drives it, without validation or checkpoints: `run_epoch` with
`make_train_step`'s step over a `DeviceCorpus`, epoch after epoch with the
epoch as the shuffle seed, under `device.deterministic_algorithms()`, the
augmentation drawn from one CPU generator. The corpus comes from a dataset
stand-in (`CorpusStandIn`) that offers what `DeviceCorpus` reads, with
tuples made from the seed on the card instead of decoded JPEGs.

Set-up builds the one training state (the port's model with the seeded
weights, its `OptaxAdam`) and drives it through its first three steps,
through the window's own call and feed, recording each step's loss, the
first gradient as Adam took it (from its first moment after one step) and
each leaf's change after the three; then hands the same state to the
window, which runs steps until `seconds` have passed (the step in flight
is finished, then the epoch's metrics are fetched). The traced run runs
the mix's `trace_steps` steps on the host's clock alone, then as many again
under the profiler; the shares of the card's time take the untraced steps'
time as their window, since the profiler lengthens the host's work.

`correct` holds those readings against the plain float32 reference's
three steps from the same weights, rows and augmentation
(reference/train.py):
* `logit_gap`: the largest gap of the first step's log-odds of the
  positive class over the batch, in nats (the program's from its float32
  probabilities);
* `grad_gap`: the median leaf's gap between the program's and the
  reference's norm of the first gradient, over the larger of the
  reference's norm of that leaf and of the median leaf (the worst leaf's
  gap is the bf16 backward's rounding at the early batch-norm leaves,
  which the reference under bf16 autocast shows alike: PERF.md);
* `change_gap`: the worst leaf's gap, measured alike, of the norm of each
  leaf's change after the three steps. Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out: Adam moves them by
  round-off alone.
Each step's loss is not compared: neither the control nor a planted fault
reads far enough above sound runs for a limit to hold (PERF.md).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import synthetic
from benchmark.reference import train as ref_train
from benchmark.drivers.fused_scoring import log_odds
from benchmark.tracing import Spans, profile
from benchmark.weights import arch_of, make_state_dict

CHECKED_STEPS = 3
ADAM_B1 = 0.9


class CorpusStandIn:
    """What `DeviceCorpus` reads of a `BEVPairDataset`: `data_list` (tuples
    whose last item is the label), `n_imgs`, `args.resize_h/resize_w` and
    `_load_tuples`, here rows made by `synthetic.corpus_chunk`."""

    class _Args:
        def __init__(self, px: int) -> None:
            self.resize_h = self.resize_w = px

    def __init__(self, n: int, n_imgs: int, px: int, seed: int, device) -> None:
        self.seed, self.device, self.n_imgs = seed, device, n_imgs
        self.args = self._Args(px)
        self.data_list = [(row, int(label)) for row, label in enumerate(synthetic.corpus_labels(seed, n))]

    def __len__(self) -> int:
        return len(self.data_list)

    def _load_tuples(self, tuples) -> np.ndarray:
        return rows_of(self.seed, [t[0] for t in tuples], (self.n_imgs, self.args.resize_h, self.args.resize_w, 3),
                       self.device).cpu().numpy()


def rows_of(seed: int, rows: List[int], shape, device) -> torch.Tensor:
    """Corpus rows `rows`, in order, made again from the seed."""
    rows = np.asarray(rows)
    out = torch.empty((len(rows), *shape), dtype=torch.uint8, device=device)
    for chunk in np.unique(rows // synthetic.CORPUS_CHUNK):
        sel = np.nonzero(rows // synthetic.CORPUS_CHUNK == chunk)[0]
        block = synthetic.corpus_chunk(seed, int(chunk), synthetic.CORPUS_CHUNK, shape, device)
        out[torch.as_tensor(sel, device=device)] = block[torch.as_tensor(rows[sel] % synthetic.CORPUS_CHUNK,
                                                                         device=device)]
    return out


class Feed:
    """The corpus's `iter_batches`, continued across calls of one epoch and
    cut at a step count or a deadline (checked before each next batch)."""

    def __init__(self, corpus) -> None:
        self.corpus = corpus
        self._live: Dict[int, object] = {}
        self.limit = None
        self.deadline = None
        self.steps = 0
        self.rows: List[List[int]] = []

    def iter_batches(self, batch_size: int, shuffle: bool, seed: int = 0):
        it = self._live.setdefault(seed, self.corpus.iter_batches(batch_size, shuffle, seed))
        n = 0
        for batch in it:
            self.steps += 1
            if len(self.rows) < CHECKED_STEPS:
                self.rows.append([t[0] for t in batch[2]])
            yield batch
            n += 1
            if (self.limit is not None and n >= self.limit) or \
                    (self.deadline is not None and time.perf_counter() >= self.deadline):
                return
        del self._live[seed]

    def epoch_open(self, seed: int) -> bool:
        return seed in self._live


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from salve_tpu_torch.device import deterministic_algorithms, resolve_device
    from salve_tpu_torch.training import loop, train as train_lib
    from salve_tpu_torch.training.config import TrainingConfig
    from salve_tpu_torch.training.device_corpus import DeviceCorpus

    if config["apply_photometric_augmentation"] or config["optimizer"] != "adam" or \
            config["lr_annealing_strategy"] != "poly":
        raise ValueError("verifier_training runs the released recipe (Adam, poly LR, no photometric "
                         "augmentation), which the reference implements")
    dev = resolve_device(device)
    cfg = TrainingConfig(num_layers=config["num_layers"], num_ce_classes=config["num_classes"],
                         modalities=tuple(config["modalities"]), compute_dtype=config["compute_dtype"],
                         resize_h=config["resize_px"], resize_w=config["resize_px"],
                         train_h=config["crop_px"], train_w=config["crop_px"], batch_size=config["batch_size"],
                         base_lr=config["base_lr"], weight_decay=config["weight_decay"],
                         poly_lr_power=config["poly_lr_power"], num_epochs=config["num_epochs"],
                         optimizer_algo=config["optimizer"], lr_annealing_strategy=config["lr_annealing_strategy"],
                         apply_photometric_augmentation=config["apply_photometric_augmentation"],
                         print_every=config["print_every"])
    n = mix["corpus_tuples"]
    max_iter = cfg.num_epochs * (n // cfg.batch_size)
    model = train_lib.build_model(cfg)
    model.load_state_dict(make_state_dict(arch_of(config), seed, dev))
    model.to(dev)
    state = train_lib.TrainState(model=model, optimizer=train_lib.make_optimizer(cfg, max_iter, model))
    step = train_lib.make_train_step(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    out: Dict = {"metrics": {}, "ctx": {}}

    with deterministic_algorithms():
        corpus = DeviceCorpus(CorpusStandIn(n, model.n_images, cfg.resize_h, seed, dev), dev)
        feed = Feed(corpus)
        readings = _first_steps(cfg, loop, state, step, feed, gen)
        epoch = 0 if feed.epoch_open(0) else 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # The inputs made in set-up live through the window: keep the collector
        # from walking them again and again.
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        start_steps = feed.steps

        def run_steps(limit=None, deadline=None):
            nonlocal epoch, state
            feed.deadline = deadline
            first = feed.steps
            while True:
                feed.limit = None if limit is None else limit - (feed.steps - first)
                before = feed.steps
                state, m = loop.run_epoch(cfg, epoch, state, (step, step), feed, "train", gen=gen)
                out["failed"] = out.get("failed", 0) + (0 if np.isfinite(m["avg_loss"]) else feed.steps - before)
                if not feed.epoch_open(epoch):
                    epoch += 1
                if (limit is not None and feed.steps - first >= limit) or \
                        (deadline is not None and time.perf_counter() >= deadline):
                    return

        if trace:
            t0 = time.perf_counter()
            run_steps(limit=mix["trace_steps"])  # ends on the epoch's metrics fetch: the card is idle
            plain_s = time.perf_counter() - t0
            traced_from = feed.steps
            spans = Spans()
            spans.wrap(loop, "_fold", "fold")
            spans.wrap(loop, "_metrics_from_acc", "sync")
            spans.wrap(corpus, "gather", "gather")
            spans.wrap(state.optimizer, "step", "optimizer")
            spans.wrap(state.model, "forward", "forward")
            traced_step = step

            def step(*a, **k):  # noqa: F811
                with torch.profiler.record_function("bench/train_step"):
                    return traced_step(*a, **k)

            try:
                _, summary = profile(lambda: run_steps(limit=mix["trace_steps"]))
            finally:
                spans.restore()
            out["ctx"] = {"trace": summary, "plain_window_s": plain_s,
                          "units": (feed.steps - traced_from) * cfg.batch_size}
        else:
            t0 = time.perf_counter()
            run_steps(deadline=t0 + seconds)
            window = time.perf_counter() - t0
            out["metrics"] = {"train_tuples_per_s": (feed.steps - start_steps) * cfg.batch_size / window,
                              "setup_s": setup_s}
            out["window_s"] = window
    out["attempted"] = feed.steps - start_steps
    out.setdefault("failed", 0)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the reference runs.
    rows = feed.rows
    labels = [[corpus.dataset.data_list[r][1] for r in rs] for rs in rows]
    del state, corpus, feed, model, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(config, mix, seed, rows, labels, readings, dev, max_iter, precision="fp32")
    return out


def _first_steps(cfg, loop, state, step, feed, gen) -> Dict:
    """Drive the state through CHECKED_STEPS steps of the window's own call
    and feed, reading each step's loss, the first gradient as Adam took it
    and each leaf's change after the last."""
    opt = state.optimizer
    start = [p.detach().clone() for p in opt.params]
    names = state.param_names()
    got: Dict = {"loss": []}
    opt_step = opt.step

    def reading_step():
        opt_step()
        if opt.count == 1:
            got["grad"] = torch.stack(torch._foreach_norm(opt.mu)) / (1.0 - ADAM_B1)
        if opt.count == CHECKED_STEPS:
            got["change"] = torch.stack(torch._foreach_norm(torch._foreach_sub(opt.params, start)))

    def reading_train_step(*a, **k):
        s, m = step(*a, **k)
        if not got["loss"]:
            got["p1"] = m["probs"][:, 1].detach().clone()
        got["loss"].append(m["loss"].detach().clone())
        return s, m

    opt.step = reading_step
    try:
        feed.limit = CHECKED_STEPS
        loop.run_epoch(cfg, 0, state, (reading_train_step, reading_train_step), feed, "train", gen=gen)
    finally:
        del opt.step
    return {"loss": [float(x) for x in got["loss"]],
            "first_margins": log_odds(got["p1"].double().cpu().numpy()),
            "grad_norms": dict(zip(names, got["grad"].tolist())),
            "change_norms": dict(zip(names, got["change"].tolist()))}


def judge(config, mix, seed, rows, labels, prog: Dict, dev, max_iter: int, precision: str) -> Dict:
    """loss_gap, grad_gap and change_gap of the program's readings `prog`
    against the reference's three steps at `precision`."""
    state = make_state_dict(arch_of(config), seed, dev)
    shape = (config["n_images"], config["resize_px"], config["resize_px"], 3)
    batches = [(rows_of(seed, r, shape, dev), torch.as_tensor(lab, device=dev)) for r, lab in zip(rows, labels)]
    recipe = {"train_px": config["crop_px"], "base_lr": config["base_lr"], "poly_lr_power": config["poly_lr_power"],
              "weight_decay": config["weight_decay"], "max_iter": max_iter}
    ref = ref_train.train_steps(state, arch_of(config), recipe, batches, torch.Generator().manual_seed(int(seed)),
                                precision)
    return gaps(prog, ref)


def gaps(prog: Dict, ref: Dict) -> Dict:
    """The compared numbers of two sets of readings (module docstring)."""
    keys = ("logit_gap", "grad_gap", "change_gap")
    if len(prog["first_margins"]) != len(ref["first_margins"]):
        return {k: float("inf") for k in keys}
    logit = np.abs(np.subtract(prog["first_margins"], ref["first_margins"]))
    names = list(ref["grad_norms"])
    g_ref = np.array([ref["grad_norms"][k] for k in names])
    g_med = np.median(g_ref)
    grad = np.abs(np.array([prog["grad_norms"][k] for k in names]) - g_ref) / np.maximum(g_ref, g_med)
    moved = [k for k, g in zip(names, g_ref) if g >= 1e-3 * g_med]
    c_ref = np.array([ref["change_norms"][k] for k in moved])
    change = np.abs(np.array([prog["change_norms"][k] for k in moved]) - c_ref) / np.maximum(c_ref, np.median(c_ref))
    if not all(np.all(np.isfinite(x)) for x in (logit, grad, change)):
        return {k: float("inf") for k in keys}
    return {"logit_gap": float(logit.max()), "grad_gap": float(np.median(grad)), "change_gap": float(change.max())}

def control(config: Dict, mix: Dict, seed: int, device, precision: str = "fp8") -> Dict:
    """The control's checks: the reference at `precision` put in the program's
    place for CHECKED_STEPS steps on distinct rows drawn from the seed,
    judged against the float32 reference."""
    dev = torch.device("cuda" if device is None else device)
    n, b = mix["corpus_tuples"], config["batch_size"]
    perm = np.random.default_rng(np.random.SeedSequence([int(seed), 41])).permutation(n)
    rows = [perm[i * b:(i + 1) * b].tolist() for i in range(CHECKED_STEPS)]
    all_labels = synthetic.corpus_labels(seed, n)
    labels = [all_labels[r].tolist() for r in rows]
    shape = (config["n_images"], config["resize_px"], config["resize_px"], 3)
    batches = [(rows_of(seed, r, shape, dev), torch.as_tensor(lab, device=dev)) for r, lab in zip(rows, labels)]
    recipe = {"train_px": config["crop_px"], "base_lr": config["base_lr"], "poly_lr_power": config["poly_lr_power"],
              "weight_decay": config["weight_decay"], "max_iter": config["num_epochs"] * (n // b)}
    readings = ref_train.train_steps(make_state_dict(arch_of(config), seed, dev), arch_of(config), recipe, batches,
                                     torch.Generator().manual_seed(int(seed)), precision)
    del batches
    return judge(config, mix, seed, rows, labels, readings, dev, recipe["max_iter"], precision="fp32")
