"""The port's standard-library YAML reader and writer
(``enhancing_tpu_torch.utils.yaml_io``) against ``yaml.safe_load``.

The reader gives every shipped ``configs/*.yaml`` and a set of YAML 1.1
resolution cases the values ``yaml.safe_load`` gives; the writer's text
reads back through ``yaml.safe_load`` to the value written; and in a
process where pyyaml, JAX and the JAX package cannot be imported, every
module of the port imports and ``load_config`` reads every config.
"""
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import yaml

from enhancing_tpu_torch.utils import yaml_io
from enhancing_tpu_torch.utils.config import load_config, remap_targets

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))

CASES = [
    "a: 1e-4", "a: 1.0e-4", "a: 1.0e4", "a: -1.5e+3", "a: 1.5E-3",
    "a: 12.", "a: .5", "a: +3", "a: 0x1F", "a: 017", "a: 0b101",
    "a: 1_000", "a: 1:30", "a: 1:30.5", "a: .inf", "a: -.inf",
    "a: yes", "a: No", "a: on", "a: OFF", "a: true", "a: False",
    "a: ~", "a: null", "a: NULL", "a:", "a: 'it''s'", 'a: "x\\ty\\u00e9"',
    "a: '1e-4'", 'a: "yes"', "a: hello world", "a: x#y", "a: c:/x",
    "a: 3  # comment", "a: [1, 2, [3, 4]]", "a: [1,\n  2, 3]",
    "a: {b: 1, c: [x, y], d: }", "a: {dim: 768, depth: 12}",
    "- 1\n- a: 2\n  b: 3\n- - 4\n  - 5", "a:\n- 1\n- 2\nb: 3",
    "# top\na:\n  b:\n    c: d\n  e: f\n", "'q k': v", "1: x", "yes: 2",
    "---\na: 1", "",
]


def _same(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_reader_equals_safe_load_on_shipped_configs(path):
    want = yaml.safe_load(path.read_text())
    assert yaml_io.load(path) == want
    # load_config = the reader + the target remap (no base_config here)
    assert load_config(path).to_dict() == remap_targets(want)


@pytest.mark.parametrize("text", CASES)
def test_reader_resolves_scalars_as_safe_load(text):
    want = yaml.safe_load(text)
    got = yaml_io.loads(text)
    assert got == want
    if isinstance(want, dict):
        for k in want:
            assert _same(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !!str 1",
                                  "a: |\n  x", "a: 2001-12-14"])
def test_reader_refuses_what_it_does_not_hold(text):
    with pytest.raises(ValueError):
        yaml_io.loads(text)


VALUES = [
    {"a": 1e-5, "b": [1, 2.5, "1e-4", "yes", None, True, "", " x", "a: b",
                      "#c", {"k": []}, {}, [1, [2]]],
     "c": {"d": "x\ny", "e": 1e20, "f": -0.0, "g": "東京", "h": "null",
           "i": "0x10", "j": "12:30", "k": float("inf"), 3: "int key"}},
    [[1, [2]], {"x": [{"y": 1}]}, ("a", "b")],
    "plain", 3, None, {},
]


@pytest.mark.parametrize("value", VALUES)
def test_writer_reads_back_through_safe_load(value):
    text = yaml_io.dumps(value)
    want = yaml.safe_load(yaml.safe_dump(value))
    assert yaml.safe_load(text) == want
    assert yaml_io.loads(text) == want


def test_port_imports_and_reads_configs_without_pyyaml_or_jax():
    """No module of the port imports pyyaml, JAX, flax, orbax or the JAX
    package; load_config reads every shipped config without pyyaml."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("yaml", "jax", "jaxlib", "flax", "orbax",
                     "orbax.checkpoint", "enhancing_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(REPO)!r})
        import enhancing_tpu_torch
        for mod in pkgutil.walk_packages(enhancing_tpu_torch.__path__,
                                         "enhancing_tpu_torch."):
            importlib.import_module(mod.name)
        from pathlib import Path
        from enhancing_tpu_torch.utils.config import load_config
        n = 0
        for path in sorted(Path({str(REPO / "configs")!r}).glob("*.yaml")):
            assert load_config(path).model.target.startswith(
                "enhancing_tpu_torch.")
            n += 1
        print("read", n)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["read", str(len(CONFIGS))]
