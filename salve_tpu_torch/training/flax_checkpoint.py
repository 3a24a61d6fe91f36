"""Read a salve_tpu `train_ckpt.flax` without flax or msgpack.

`flax.serialization.to_bytes` writes the checkpoint's state dict as
msgpack: nested maps with string keys (tuples become maps keyed "0", "1",
..., an optax namedtuple a map of its fields, an empty state an empty map),
and every array as msgpack ext type 1 (ext 3 for a numpy scalar) whose
payload is itself msgpack: [shape, dtype name, C-order bytes]. Arrays over
2**30 bytes are split into a map {"__msgpack_chunked_array__": true,
"shape": ..., "chunks": ...}. `read_flax_msgpack` reads exactly that
subset: maps, arrays, strings, binary, nil, booleans, integers, floats and
those ext types; anything else raises.

`flax_checkpoint_to_port` maps the salve_tpu TrainState payload
{params, batch_stats, opt_state, step} onto the port: params and
batch_stats through `models/weights.py:state_dict_from_flax`, optax's
chain(add_decayed_weights, adam) state onto the port's Adam (count, mu,
nu, the schedule's count), and the step.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

from salve_tpu_torch.models.weights import state_dict_from_flax

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.d = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.d):
            raise ValueError("msgpack data ends inside an object")
        out = self.d[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02X} is outside the subset flax writes")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array (flax writes 1 and 3)")
        inner = _Reader(payload)
        shape, dtype, buf = inner.obj()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy()
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(data: bytes) -> Any:
    """The state dict that `flax.serialization.msgpack_restore` returns."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.d):
        raise ValueError(f"{len(r.d) - r.pos} bytes follow the checkpoint's object")
    return _unchunk(out)


def _param_names(tree: Dict, num_layers: int, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A params-shaped tree (params, or Adam's mu/nu) as port parameter names."""
    sd = state_dict_from_flax(tree, batch_stats, num_layers)
    return {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def flax_checkpoint_to_port(ckpt_fpath: str, num_layers: int) -> Dict[str, Any]:
    """salve_tpu's train_ckpt.flax as the port's checkpoint payload:
    {"model": state_dict, "opt_state": {"count", "mu", "nu", "schedule_count"}, "step"}."""
    with open(ckpt_fpath, "rb") as f:
        tree = read_flax_msgpack(f.read())
    params, batch_stats = tree["params"], tree["batch_stats"]
    adam, sched = tree["opt_state"]["1"]["0"], tree["opt_state"]["1"]["1"]
    return {
        "model": state_dict_from_flax(params, batch_stats, num_layers),
        "opt_state": {
            "count": int(adam["count"]),
            "mu": _param_names(adam["mu"], num_layers, batch_stats),
            "nu": _param_names(adam["nu"], num_layers, batch_stats),
            "schedule_count": int(sched["count"]),
        },
        "step": int(tree["step"]),
    }

