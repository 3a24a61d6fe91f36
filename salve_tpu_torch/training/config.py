"""Training hyperparameters (copy of salve_tpu/training/config.py:TrainingConfig).

Defaults follow the best released model's config: ResNet-152, batch 256,
234 -> 224 crops, ceiling+floor RGB modalities, bf16 compute.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


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
