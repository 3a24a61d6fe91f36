"""Training hyperparameters (copy of salve_tpu/training/config.py).

Defaults follow the best released model's config: ResNet-152, batch 256,
234 -> 224 crops, ceiling+floor RGB modalities, bf16 compute.

`load_training_config` reads the reference's hydra YAML files without
PyYAML (the card's machine has none): a reader of the subset that the
port's copies of them, salve_tpu_torch/configs/*.yaml, use — one top-level `TrainingConfig:` mapping of
scalars, empty values and flow lists, with comments — that resolves each
scalar as PyYAML's safe loader does and raises, naming the line, on
anything else.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class TrainingConfig:
    """Model training hyperparameters for a single experiment."""

    lr_annealing_strategy: str = "poly"
    base_lr: float = 0.001
    weight_decay: float = 0.0001
    num_ce_classes: int = 2
    print_every: int = 10
    poly_lr_power: float = 0.9
    optimizer_algo: str = "adam"
    num_layers: int = 152
    pretrained: bool = True
    dataparallel: bool = True
    resize_h: int = 234
    resize_w: int = 234
    train_h: int = 224
    train_w: int = 224
    apply_photometric_augmentation: bool = False
    class_balanced_loss: bool = False
    modalities: Tuple[str, ...] = ("ceiling_rgb_texture", "floor_rgb_texture")

    cfg_stem: str = ""
    num_epochs: int = 50
    workers: int = 15
    batch_size: int = 256

    data_root: str = ""
    layout_data_root: str = ""
    model_save_dirpath: str = ""
    gpu_ids: Optional[str] = None

    compute_dtype: str = "bfloat16"
    mesh_shape: Optional[Tuple[int, ...]] = None
    append_pair_difference: bool = False
    decoded_cache_gb: float = 8.0
    device_corpus_gb: float = 0.0
    split_overrides: Optional[Dict[str, str]] = None


# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py) for the forms
# the reader accepts.
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")
_INF_NAN = {f"{sign}.{w}": float(f"{sign}inf") for sign in ("", "+", "-") for w in ("inf", "Inf", "INF")}
_INF_NAN.update({f".{w}": float("nan") for w in ("nan", "NaN", "NAN")})
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


class ConfigSyntaxError(ValueError):
    """A line outside the YAML subset that load_training_config reads."""


def _fail(fpath: str, lineno: int, line: str, why: str) -> None:
    raise ConfigSyntaxError(f"{fpath}:{lineno}: {why}: {line.rstrip()!r}")


def _strip_comment(text: str) -> str:
    """Drop a trailing ` # comment` outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, where) -> Any:
    text = text.strip()
    if text and text[0] in "\"'":
        if len(text) < 2 or text[-1] != text[0] or text[0] in text[1:-1] or "\\" in text:
            where("a quoted scalar must be one simple quoted string (no escapes, no inner quotes)")
        return text[1:-1]
    if text and text[0] in "[]{}&*!|>%@`,":
        where("only plain or quoted scalars and one-level flow lists are read")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _INF_NAN:
        return _INF_NAN[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text[0] in "-+.0123456789" or ": " in text or text.endswith(":"):
        # YAML 1.1 would read other numerals (0x.., 0o.., 1:30, 1e5) or nested keys here.
        where("a numeral or key form this reader does not resolve")
    return text


def _flow_list(text: str, where) -> List[Any]:
    inner = text.strip()[1:-1]
    if "[" in inner or "]" in inner or "{" in inner:
        where("nested flow collections are not read")
    if not inner.strip():
        return []
    items = re.findall(r"\s*(\"[^\"]*\"|'[^']*'|[^,]+?)\s*(?:,|$)", inner)
    if ",".join(items).replace(" ", "") != inner.replace(" ", "").rstrip(","):
        where("a flow list must be comma-separated scalars")
    return [_scalar(item, where) for item in items]


def read_config_yaml(fpath: str) -> Dict[str, Dict[str, Any]]:
    """Parse a salve_tpu-style config file: {"TrainingConfig": {key: value}}."""
    top: Optional[str] = None
    body: Dict[str, Any] = {}
    indent: Optional[int] = None
    with open(fpath, "r") as f:
        lines = f.read().splitlines()
    for lineno, line in enumerate(lines, start=1):

        def where(why: str, _n=lineno, _l=line) -> None:
            _fail(fpath, _n, _l, why)

        if "\t" in line:
            where("tabs are not read")
        text = _strip_comment(line)
        if not text.strip():
            continue
        if text.strip() in ("---", "..."):
            where("document markers are not read")
        lead = len(text) - len(text.lstrip(" "))
        m = _KEY.match(text.strip())
        if not m:
            where("expected `key: value`")
        key, value = m.group(1), m.group(2)
        if lead == 0:
            if top is not None:
                where("only one top-level mapping (TrainingConfig:) is read")
            if key != "TrainingConfig" or (value or "").strip():
                where("the top level must be `TrainingConfig:` alone")
            top = key
            continue
        if top is None:
            where("a key before `TrainingConfig:`")
        if indent is None:
            indent = lead
        elif lead != indent:
            where("nested mappings are not read; every key takes one indent")
        if key in body:
            where(f"duplicate key {key!r}")
        value = (value or "").strip()
        if value.startswith("["):
            if not value.endswith("]"):
                where("a flow list must close on its line")
            body[key] = _flow_list(value, where)
        else:
            body[key] = _scalar(value, where)
    if top is None:
        raise ConfigSyntaxError(f"{fpath}: no `TrainingConfig:` mapping")
    return {top: body}


def load_training_config(yaml_fpath: str) -> TrainingConfig:
    """Load a reference-format hydra YAML (TrainingConfig: {_target_, ...}).

    Same rules as salve_tpu/training/config.py:73: `_target_` and empty
    values are dropped, `modalities` becomes a tuple, unknown keys are
    ignored.
    """
    params = dict(read_config_yaml(yaml_fpath)["TrainingConfig"])
    params.pop("_target_", None)
    params = {k: v for k, v in params.items() if v is not None}
    if "modalities" in params:
        params["modalities"] = tuple(params["modalities"])
    known = set(TrainingConfig.__dataclass_fields__)
    return TrainingConfig(**{k: v for k, v in params.items() if k in known})
