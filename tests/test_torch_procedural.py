"""The port's copy of the procedural ZInD generator against salve_tpu's.

`chip_smoke.py` and the port's tests make their floors with the copy, so it
must give the same building for the same arguments, byte for byte.
"""

import json

import pytest

from salve_tpu.dataset import procedural as jprocedural
from salve_tpu_torch.dataset import procedural
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("style", ["default", "pathological", "rotation_trap"])
@pytest.mark.parametrize("version", [11, 12])
@pytest.mark.parametrize("seed,size", [(0, None), (3, None), (7 * 99991 + 38, None), (1, 4)])
def test_generate_building_json_matches_salve_tpu(seed, size, version, style):
    kwargs = dict(seed=seed, n_rows=size, n_cols=size, version=version, style=style)
    got = json.dumps(procedural.generate_building_json(**kwargs), sort_keys=True)
    assert got == json.dumps(jprocedural.generate_building_json(**kwargs), sort_keys=True)


def test_write_procedural_buildings_matches_salve_tpu(tmp_path):
    ids = ["0003", "0004", "0005"]
    styles = {"0004": "pathological", "0005": "rotation_trap"}
    procedural.write_procedural_buildings(str(tmp_path / "port"), ids, base_seed=5, version=12, styles=styles)
    jprocedural.write_procedural_buildings(str(tmp_path / "ref"), ids, base_seed=5, version=12, styles=styles)
    for bid in ids:
        got = (tmp_path / "port" / bid / "zind_data.json").read_bytes()
        assert got == (tmp_path / "ref" / bid / "zind_data.json").read_bytes()
