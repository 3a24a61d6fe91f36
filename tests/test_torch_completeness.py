"""The port does all that salve_tpu does: every public name has a counterpart.

An `ast` pass over every `salve_tpu/**.py` (nothing is imported) lists each
public top-level function and class, and each public or dunder method of a
public class. Each must have a counterpart of the same name in the port's
module of the same path (`salve_tpu_torch/...`), with two rules and one
allow-list:
  * a click command (`@click.command`) became the module's argparse `main`;
  * a Flax module's `__call__` became its torch module's `forward`;
  * `RENAMED` names the port's counterpart where it has another name or
    module, and `JAX_ONLY` the names that exist for JAX alone, each with
    the reason. Every entry must be in use: it names a public definition
    of salve_tpu that has no counterpart of the same name.
"""

import ast
import pathlib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = REPO / "salve_tpu", REPO / "salve_tpu_torch"

# (salve_tpu module, name) -> (port module, port name, reason).
RENAMED = {
    ("models/resnet.py", "BottleneckBlock"): (
        "models/resnet.py", "Bottleneck", "torchvision's name, whose .pth keys the port loads"),
    ("models/resnet.py", "BottleneckBlock.__call__"): (
        "models/resnet.py", "Bottleneck.forward", "the torch module's forward"),
    ("models/resnet.py", "ResNet"): ("models/resnet.py", "ResNetTrunk", "the trunk without its Flax wrapper"),
    ("models/resnet.py", "ResNet.__call__"): ("models/resnet.py", "ResNetTrunk.forward", "the torch module's forward"),
    ("models/torch_weights.py", "convert_torchvision_resnet_state_dict"): (
        "models/weights.py", "convert_torchvision_resnet_state_dict", "all checkpoint formats are read in weights.py"),
    ("models/torch_weights.py", "load_reference_checkpoint"): (
        "models/weights.py", "load_reference_checkpoint", "all checkpoint formats are read in weights.py"),
    ("models/torch_weights.py", "convert_early_fusion_state_dict"): (
        "models/weights.py", "port_state_dict_from_reference", "a reference .pth needs its keys renamed, not a Flax tree"),
    ("native/loader.py", "decode_resize_batch"): (
        "native/jpeg.py", "decode_resize_batch", "the decode + resize threads live in the port's JPEG codec"),
    ("ops/pallas_splat.py", "splat_priority_grid_pallas"): ("ops/splat.py", "splat_priority_grid", "B1: csrc/splat.cu"),
    ("ops/pallas_fill.py", "fill_and_mask_batched"): ("ops/fill.py", "fill_and_mask", "B2: csrc/fill.cu, any batch"),
    ("ops/pallas_fill.py", "fill_and_mask_any_batch"): ("ops/fill.py", "fill_and_mask", "B2: csrc/fill.cu, any batch"),
    ("ops/pallas_fill.py", "fill_and_mask"): ("ops/fill.py", "fill_and_mask", "B2 at B = 1"),
    ("ops/warp.py", "render_identity_bank_extended"): (
        "rendering/bev_pair.py", "render_identity_banks",
        "the warp source is rendered with its surface's identity render, from the same cloud"),
    ("ops/pallas_warp.py", "warp_bank_sim2_shear_pallas_v2"): ("ops/warp.py", "shear_warp_cuda", "B3: csrc/warp.cu"),
    ("ops/pallas_warp.py", "warp_bank_sim2_shear_pallas"): ("ops/warp.py", "shear_warp_cuda", "B3' computes B3's function"),
    ("parallel/mesh.py", "batch_sharding"): ("parallel/mesh.py", "shard_batch", "a rank takes its rows; no sharding object"),
    ("parallel/mesh.py", "replicated_sharding"): ("parallel/mesh.py", "replicate", "parameters broadcast from rank 0"),
    ("pipeline/fused_inference.py", "make_fused_score_fn"): (
        "pipeline/fused_inference.py", "score_batch", "the jitted batch body runs eagerly, its verifier as a CUDA graph"),
    ("pipeline/fused_inference.py", "make_fused_score_fn_sharded"): (
        "pipeline/fused_inference.py", "score_floor_hypotheses", "the mesh is its `mesh=` argument"),
}

# (salve_tpu module, name) -> why the port has no counterpart.
JAX_ONLY = {
    ("models/hohonet.py", "convert_hohonet_state_dict"):
        "the port's module names are the .pth keys: load_state_dict reads the checkpoint as it is",
    ("models/torch_weights.py", "convert_trunk_state_dict"):
        "a torch trunk state dict is already the port's layout; there is no Flax tree to fill",
    ("native/loader.py", "native_loader_available"):
        "the port's codec is built from its own C source at first use and links no library, so it has no absent state",
    ("pipeline/fused_inference.py", "resolve_warp_default"):
        "it chooses by JAX backend (warp on a TPU); the port's scorer chooses warp on CUDA itself",
}


def _is_click_command(fn: ast.FunctionDef) -> bool:
    return any("click" in ast.unparse(d) and "command" in ast.unparse(d) for d in fn.decorator_list)


def _public_definitions(path: pathlib.Path):
    """(name, is a click command) of each public definition of `path`."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            yield node.name, _is_click_command(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            yield node.name, False
            for m in node.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if not m.name.startswith("_") or (m.name.startswith("__") and m.name.endswith("__")):
                    yield f"{node.name}.{m.name}", False


def _defined_names(path: pathlib.Path) -> set:
    """Every name `path` binds at top level, and Class.method of its classes."""
    out = set()
    if not path.exists():
        return out
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


def _missing():
    """[(module, name)] of salve_tpu's public definitions without a
    counterpart by name or rule, and the count of those checked."""
    missing, checked = [], 0
    for path in sorted(REF.rglob("*.py")):
        rel = str(path.relative_to(REF))
        have = _defined_names(PORT / rel)
        for name, click_command in _public_definitions(path):
            checked += 1
            if name in have or (click_command and "main" in have):
                continue
            if name.endswith(".__call__") and name.replace("__call__", "forward") in have:
                continue
            missing.append((rel, name))
    return missing, checked


def test_every_public_name_of_salve_tpu_has_a_counterpart():
    missing, checked = _missing()
    assert checked > 600
    unexplained = [m for m in missing if m not in RENAMED and m not in JAX_ONLY]
    assert unexplained == [], f"public names of salve_tpu without a counterpart in the port: {unexplained}"
    # Each entry is in use, and each rename's counterpart exists.
    assert sorted(set(RENAMED) | set(JAX_ONLY)) == sorted(missing)
    for (rel, name), (port_rel, port_name, reason) in RENAMED.items():
        assert port_name in _defined_names(PORT / port_rel), (rel, name, port_rel, port_name)
        assert reason
    assert all(JAX_ONLY.values())


def test_the_three_pallas_modules_are_cuda_kernels():
    """The Pallas modules have no Python counterpart: their functions are the
    hand-written kernels under csrc/, reached through ops/{splat,fill,warp}.py."""
    for rel in ("ops/pallas_splat.py", "ops/pallas_fill.py", "ops/pallas_warp.py"):
        assert not (PORT / rel).exists()
        names = {n for n, _ in _public_definitions(REF / rel)}
        assert names and all((rel, n) in RENAMED for n in names)
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {"splat.cu", "fill.cu", "warp.cu"}
