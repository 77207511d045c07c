"""``BENCHMARK.json`` against the rules its format keeps, every file it names
found by name, and the yardstick's frozen arithmetic against values worked
by hand."""

from __future__ import annotations

import ast
import json
import math
import re

import pytest

from portbench import spec, work
from portbench.spec import ROOT

BENCH = spec.Bench()
DATA = BENCH.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in DATA["workloads"]]
METRICS = DATA["end_to_end"] + DATA["per_layer"]


def test_the_top_level_keys_and_the_command():
    assert list(DATA) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"]
    assert DATA["command"] == ["python3", "portbench/run.py"] and DATA["paths"] == ["portbench"]
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert len(json.dumps(DATA)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (DATA["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", DATA["configs"] + DATA["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines_keep_to_their_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (DATA["configs"], DATA["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    entry = BENCH.cell(cell)
    config, traffic = BENCH.config(entry["config"]), BENCH.traffic(entry["traffic"])
    assert config["model"]["layers"] and traffic["kind"] in ("prefill", "decode")
    assert BENCH.limits(cell)
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.reader(m["name"]))
    assert entry["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(cell)


@pytest.mark.parametrize("metric", DATA["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["moves"] in {m["name"] for m in DATA["end_to_end"]}
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in BENCH.end_to_end(cell)}
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()


def test_bounds_and_sources():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in DATA["end_to_end"])
    for m in DATA["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda e: e["name"])
def test_each_configuration_file_states_its_cut(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/")
    assert config["source"] == entry["source"]
    assert set(config["reduced"]) == set(entry["reduced"])
    for key in entry["reduced"]:
        assert key in config
        assert not re.search(r"(_dim|_rank|size|heads|experts_per_tok)$", key)
    for key in ("assumed", "deployment", "departures", "dtypes"):
        assert config[key]
    # a key the port departs from keeps its published value: only the cut's
    # keys differ from the source
    for key, dep in config["departures"].items():
        if isinstance(dep, dict):
            assert config.get(key, dep["published"]) == dep["published"], key
            assert key not in config["reduced"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_here_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not {"jax", "jaxlib", "flax", "repro"} & set(_imports(path)), path


#: what a plain reference may import besides its sibling references, which
#: it imports relatively (``from . import model``) so that they come from the
#: run's own root: nothing of the program or the yardstick
REFERENCE_IMPORTS = ("__future__", "math", "torch")


def _foreign_imports(path):
    """The modules ``path``, a file of ``portbench/reference/``, imports
    beyond ``REFERENCE_IMPORTS`` and its siblings."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level != 1:
            names = ["." * node.level + (node.module or "")]
        else:
            continue
        yield from (n for n in names if n.split(".")[0] not in REFERENCE_IMPORTS)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not list(_foreign_imports(path)), path


@pytest.mark.parametrize("line", ["import repro_torch", "from repro_torch.models import blocks",
                                  "import portbench.work", "from portbench import work",
                                  "from .. import work", "import numpy",
                                  "from portbench.reference import model"])
def test_the_reference_import_rule_refuses_the_program_and_the_yardstick(tmp_path, line):
    path = tmp_path / "sibling.py"
    path.write_text(f"from . import model\n{line}\n")
    assert list(_foreign_imports(path)) != []
    path.write_text("from __future__ import annotations\nimport torch.nn.functional as F\n"
                    "from . import model\nfrom .model import Precision\n")
    assert list(_foreign_imports(path)) == []


def test_flash_work_by_hand():
    # jamba's 32k GQA layer: q (1, 32, 32768, 128), kv (1, 8, 32768, 128), bf16
    nbytes, flops = work.flash_work(1, 32, 8, 32768, 128, 2)
    assert nbytes == 2 * (32 + 8) * 32768 * 128 * 2 == 671_088_640
    assert flops == 4 * 128 * 32 * (32768 * 32769 // 2) == 8_796_361_457_664
    assert work.bound_s(nbytes, flops, 989e12) == pytest.approx(8.894198e-3, rel=1e-6)


def test_route_work_by_hand():
    # one chunk: seven operations a term, dt*x a channel, no combine
    assert work.route_work(1, 128, 4, 2, 128, 4) == ((3 * 128 * 4 + 2 * 128 * 2) * 4 + 32 + 32,
                                                      7 * 128 * 4 * 2 + 128 * 4)
    # three chunks of 2: the middle chunk's two more a term, two chunk ends
    nbytes, flops = work.route_work(1, 6, 1, 1, 2, 2)
    assert nbytes == (3 * 6 + 2 * 6) * 2 + 4 + 4
    assert flops == 7 * 6 + 2 * 2 + 6 + 2 * (2 + 4)
    # jamba's first 32k Mamba layer, the bound its kernel table states
    assert work.bound_s(*work.route_work(1, 32768, 8192, 16, 128, 2), 67e12) \
        == pytest.approx(0.5859e-3, rel=1e-4)


def test_model_flops_by_hand():
    m = {"d_model": 4, "vocab": 10, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
         "d_ff": 8, "moe_experts": 4, "moe_top_k": 2, "moe_shared": 1, "moe_d_ff": 3,
         "layers": [["gqa", "swiglu"], ["gqa", "moe"]]}
    attn = 2 * 4 * 2 * 2 + 2 * 4 * 1 * 2                 # wq, wo; wk, wv: 48
    per_token = 4 * 10 + 2 * attn + 3 * 4 * 8 + (4 * 4 + 3 * 4 * 3 * (2 + 1))
    assert work.matmul_params_per_token(m) == per_token == 356
    assert work.model_flops(m, 5, 15) == 2 * 356 * 5 + 2 * (4 * 2 * 2) * 15
    mla = {"d_model": 8, "vocab": 2, "n_heads": 2, "mla_q_rank": 3, "mla_kv_rank": 2,
           "mla_nope_dim": 2, "mla_rope_dim": 1, "mla_v_dim": 2, "layers": [["mla", "none"]]}
    assert work.matmul_params_per_token(mla) == 16 + 8 * 3 + 3 * 2 * 3 + 8 * 3 + 2 * 2 * 4 + 2 * 2 * 8
    assert work.attention_flops_per_pair(mla) == 2 * (3 + 2) * 2
    mamba = {"d_model": 2, "vocab": 3, "mamba_d_inner": 4, "mamba_dt_rank": 1,
             "mamba_d_state": 2, "layers": [["mamba", "none"]]}
    assert work.matmul_params_per_token(mamba) == 6 + 2 * 8 + 4 * 5 + 4 + 8
    assert math.isclose(work.STEP_PEAK_FLOPS_PER_S["float32"], 67e12)
