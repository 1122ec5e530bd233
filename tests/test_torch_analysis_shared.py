"""The framework-free half of the port's graftlint against the JAX
package's: R6 config-key, R8 swallow, R9 emit-hot on the dispatch-hot
path, the suppression comments, ``skip-file``, and the baseline (round
trip, diff, schema validation). The same source goes through both engines,
each at its own package's path, and the findings must be equal in
``(rule, line, col, message, snippet)``.
"""

import json

import pytest

from nerf_replication_tpu.analysis import baseline as jax_baseline
from nerf_replication_tpu.analysis import lint_source as jax_lint
from nerf_replication_tpu_torch.analysis import (
    Finding,
    diff_baseline,
    lint_source,
    load_baseline,
    save_baseline,
    to_baseline,
    validate_baseline_data,
)

JAX_LIB = "nerf_replication_tpu/render/foo.py"
PORT_LIB = "nerf_replication_tpu_torch/render/foo.py"
_KNOWN = {("train",), ("train", "lr"), ("task_arg",), ("seed",)}


def _key(findings):
    return [(f.rule, f.line, f.col, f.message, f.snippet) for f in findings]


def both(src, jax_path=JAX_LIB, port_path=PORT_LIB, **kw):
    """``(jax findings, port findings)`` of one source."""
    return (jax_lint(src, path=jax_path, **kw),
            lint_source(src, path=port_path, **kw))


_TRY = "def {name}():\n    try:\n        work()\n{handler}"
SWALLOW = (
    _TRY.format(name="load", handler="    except Exception:\n        pass\n")
    + "def a():\n    try:\n        work()\n    except:\n        return None\n"
    + "def b():\n    try:\n        work()\n"
      "    except (ValueError, Exception):\n        return None\n"
)
SWALLOW_CLEAN = (
    _TRY.format(name="a", handler="    except Exception:\n        raise\n")
    + _TRY.format(name="b", handler="    except Exception as exc:\n"
                  "        report('artifact.load', 'error', detail=str(exc))\n"
                  "        return None\n")
    + _TRY.format(name="c", handler="    except Exception as exc:\n"
                  "        log.warning('failed: %s', exc)\n")
    + _TRY.format(name="d", handler="    except (OSError, ValueError):\n"
                  "        return None\n")
    + _TRY.format(name="e", handler="    # graftlint: ok(swallow: probe)\n"
                  "    except Exception:\n        pass\n")
)
EMIT_HOT = (
    "def render(emitter, mx):  # graftlint: hot\n"
    "    emitter.emit('serve_request', latency_s=0.1)\n"
    "    mx.counter('serve_requests_total', status='ok')\n"
    "    mx.observe('serve_request_latency_seconds', 0.1)\n"
    "    get_metrics().gauge('serve_queue_depth', 3)\n"
    "def outer(x):  # graftlint: hot\n"
    "    return helper(x)\n"
    "def helper(x):\n"
    "    get_emitter().emit('row', x=x)\n"
    "    return x\n"
)
EMIT_CLEAN = (
    "def cold(emitter):\n"
    "    emitter.emit('row', x=1)\n"
    "def hot(x):  # graftlint: hot\n"
    "    with get_tracer().span('serve.dispatch', stage='dispatch'):\n"
    "        return x * 2\n"
    "def hot2(emitter, x):  # graftlint: hot\n"
    "    # graftlint: ok(emit-hot: per-batch cadence, post-sync)\n"
    "    emitter.emit('serve_batch', n=x)\n"
    "    return x\n"
)
CONFIG = (
    "def setup(cfg):\n"
    "    lr = cfg.train.lr\n"
    "    return cfg.get('definitely_not_a_key', 1)\n"
    "def setup2(cfg):\n"
    "    n = cfg.task_arg.get('N_rays', 1024)\n"
    "    return cfg.train.lr, n, cfg.trian.lr\n"
    "def encoder(cfg):\n"
    "    return cfg.get('num_levels', 16)\n"
)
# a hazard both engines flag with one message: an emit in a hot body
HAZARD = ("def hot(emitter):  # graftlint: hot\n"
          "    emitter.emit('row', x=1)\n")


@pytest.mark.parametrize("case,src,n", [
    ("swallow", SWALLOW, 3), ("swallow_clean", SWALLOW_CLEAN, 0),
    ("emit_hot", EMIT_HOT, 5), ("emit_clean", EMIT_CLEAN, 0)])
def test_library_rules_equal(case, src, n):
    a, b = both(src)
    assert _key(a) == _key(b)
    assert [f.path for f in b] == [PORT_LIB] * n


def test_config_key_equal():
    a, b = both(CONFIG, config_keys=_KNOWN)
    assert _key(a) == _key(b)
    assert [f.line for f in b] == [3, 6]
    # without the repo's keys the rule is silent in both
    assert both(CONFIG) == ([], [])


@pytest.mark.parametrize("jax_path,port_path", [
    ("scripts/chaos_run.py", "nerf_replication_tpu_torch/tools/chaos_run.py"),
    ("tests/test_foo.py", "tests/test_foo.py"),
    ("serve.py", "chip_smoke.py"),
    ("nerf_replication_tpu/analysis/core.py",
     "nerf_replication_tpu_torch/analysis/core.py"),
])
def test_swallow_exempt_outside_library_code(jax_path, port_path):
    a, b = both(SWALLOW, jax_path=jax_path, port_path=port_path)
    assert a == [] and b == []


@pytest.mark.parametrize("comment", [
    "  # graftlint: ok(emit-hot: fixture)", "  # graftlint: ok()",
    "  # graftlint: ok", "  # graftlint: ok(rng)"])
def test_inline_suppressions_equal(comment):
    """An end-of-line ``ok(...)`` silences the named rule (or all, with
    no list); another rule's name does not."""
    src = HAZARD.replace("x=1)\n", "x=1)" + comment + "\n")
    a, b = both(src)
    assert _key(a) == _key(b)
    assert len(b) == (1 if "rng" in comment else 0)


def test_standalone_suppression_and_skip_file_equal():
    nextline = HAZARD.replace(
        "    emitter.emit", "    # graftlint: ok(emit-hot)\n    emitter.emit")
    assert both(nextline) == ([], [])
    assert both("# graftlint: skip-file\n" + HAZARD) == ([], [])
    a, b = both("\n\n" + HAZARD)  # shifted, still flagged on its line
    assert _key(a) == _key(b) and [f.line for f in b] == [4]


def test_baseline_roundtrip_and_diff(tmp_path):
    findings = lint_source(HAZARD + SWALLOW, path=PORT_LIB)
    assert len(findings) == 4
    path = str(tmp_path / "baseline.json")
    save_baseline(path, findings)
    baseline = load_baseline(path)
    new, accepted, n_fixed = diff_baseline(findings, baseline)
    assert new == [] and len(accepted) == 4 and n_fixed == 0
    # line numbers moving must not resurrect baselined findings
    shifted = lint_source("\n# shift\n" + HAZARD + SWALLOW, path=PORT_LIB)
    new, accepted, _ = diff_baseline(shifted, baseline)
    assert new == [] and len(accepted) == 4
    extra = shifted + [Finding("rng", PORT_LIB, 99, 0, "msg",
                               "gen = torch.Generator().manual_seed(0)")]
    new, _, _ = diff_baseline(extra, baseline)
    assert [f.rule for f in new] == ["rng"]
    new, accepted, n_fixed = diff_baseline([], baseline)
    assert new == [] and accepted == [] and n_fixed == 4
    # the file JAX's baseline module writes for the same findings
    assert to_baseline(findings) == jax_baseline.to_baseline(findings)
    assert jax_baseline.load_baseline(path) == baseline


def test_baseline_schema_validation(tmp_path):
    path = str(tmp_path / "baseline.json")
    save_baseline(path, lint_source(HAZARD, path=PORT_LIB))
    with open(path) as f:
        data = json.load(f)
    broken = [
        data,
        {**data, "findings": [{k: v for k, v in data["findings"][0].items()
                               if k != "snippet"}]},
        {"version": 1},
        {**data, "version": 9},
        {**data, "tool": "other"},
        {**data, "findings": [{**data["findings"][0], "index": "0"}]},
        [],
    ]
    got = [validate_baseline_data(d) for d in broken]
    assert got == [jax_baseline.validate_baseline_data(d) for d in broken]
    assert got[0] == [] and all(got[1:])
