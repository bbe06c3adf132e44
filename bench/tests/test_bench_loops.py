"""Both traffic loops, end to end on the CPU at a tiny size through
``repro_torch`` (``device="cpu"``): the result line, the control, and the
faults a cell can have, each of which has to turn ``correct`` false.

The harness's look for a card is skipped (``cell.run`` takes the
device); everything after it runs as on the card.  A cell on one card
has no exchange between cards, so that fault does not apply.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.harness import cell, check, deploy
from bench.reference.bfs import UNREACHED

BFS = "graph500-s21.bfs"
SERVE = "graph500-s21-serve.mixed-c32"
SEED = 2 ** 31 + 99


def _run(spec, workload, trace=False, **kw):
    return cell.run(workload, SEED, 0.5, trace, device="cpu", spec=spec,
                    **kw)


@pytest.mark.parametrize("workload", [BFS, SERVE])
def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny_spec, workload):
    r = _run(tiny_spec, workload, with_control=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    want = {m["name"] for m in tiny_spec.metrics(workload, False)}
    want.discard("device_peak_gib")        # no card: no device peak
    assert set(r["metrics"]) == want
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    # the control fails at least one of the cell's numbers
    ok, _ = check.judge(r["control"], {k: c["limit"] for k, c in
                                       r["checks"].items()})
    assert not ok, r["control"]


def test_the_serve_cell_checks_every_query_kind(tiny_spec):
    r = _run(tiny_spec, SERVE)
    assert {"bfs_mismatch", "sssp_mismatch", "dist_mismatch", "ppr_gap",
            "unanswered"} <= set(r["checks"])


@pytest.mark.parametrize("workload", [BFS, SERVE])
def test_a_traced_tiny_run_reports_the_per_layer_metrics_it_can(
        tiny_spec, workload):
    r = _run(tiny_spec, workload, trace=True)
    assert r["correct"] is True
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    got = set(r["metrics"])
    # with no device, only the device-trace metrics are missing
    for m in tiny_spec.metrics(workload, True):
        assert (m["name"] in got) == (m["source"] != "device_trace"), m


def _fault_run(monkeypatch, spec, workload, where, wrap):
    from repro_torch.core.translator import CompiledGraphProgram
    orig = getattr(CompiledGraphProgram, where)
    monkeypatch.setattr(CompiledGraphProgram, where, wrap(orig))
    return _run(spec, workload)


def _unchanged_run(orig):
    def run(self, roots=None, **kw):
        orig(self, roots=roots, **kw)
        return self.init_state(roots=roots)[0], 0
    return run


def _half_run(orig):
    def run(self, roots=None, **kw):
        v, it = orig(self, roots=roots, **kw)
        v = v.clone()
        v[v.numel() // 2:] = UNREACHED
        return v, it
    return run


def _altered_run(orig):
    def run(self, roots=None, **kw):
        v, it = orig(self, roots=roots, **kw)
        v = v.clone()
        v[roots] += 1
        return v, it
    return run


@pytest.mark.parametrize("wrap", [_unchanged_run, _half_run, _altered_run],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_search_is_not_correct(monkeypatch, tiny_spec, wrap):
    r = _fault_run(monkeypatch, tiny_spec, BFS, "run", wrap)
    assert r["correct"] is False and r["failed"] > 0


def _unchanged_slice(orig):
    def run_batch_slice(self, state, budget, *a, **kw):
        return state
    return run_batch_slice


def _half_values(orig):
    def lane_values(self, state, lanes):
        out = [np.array(v) for v in orig(self, state, lanes)]
        half = state.values.shape[0] // 2
        base = self._base_values.cpu().numpy()
        return [base.copy() if lane >= half or half == 0 else v
                for lane, v in zip(lanes, out)]
    return lane_values


def _altered_values(orig):
    def lane_values(self, state, lanes):
        out = [np.array(v) for v in orig(self, state, lanes)]
        for v in out:
            v[np.argmax(np.isfinite(v))] += 1
        return out
    return lane_values


@pytest.mark.parametrize("where,wrap", [
    ("run_batch_slice", _unchanged_slice),
    ("lane_values", _half_values),
    ("lane_values", _altered_values)],
    ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_server_is_not_correct(monkeypatch, tiny_spec, where, wrap):
    if where == "run_batch_slice":
        # the warm-up in set-up would never end: break the window only
        driver = tiny_spec.driver("closed_loop")
        real = driver.window

        def window(self, *a, **kw):
            from repro_torch.core.translator import CompiledGraphProgram
            monkeypatch.setattr(CompiledGraphProgram, where,
                                wrap(CompiledGraphProgram.run_batch_slice))
            return real(self, *a, **kw)
        monkeypatch.setattr(driver, "window", window)
        r = _run(tiny_spec, SERVE)
    else:
        r = _fault_run(monkeypatch, tiny_spec, SERVE, where, wrap)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


def test_searches_draw_distinct_keys_of_degree_one_or_more(tiny_spec):
    from bench.harness import spans
    cfg = tiny_spec.config("graph500-s21")
    dep = deploy.build(cfg, SEED, torch.device("cpu"), spans.Spans(),
                       tiny_spec.generator(cfg["generator"]))
    searches = tiny_spec.driver("searches")

    def keys():
        sample = check.Sample(lambda kind: 1, SEED)
        return searches(dep, tiny_spec.traffic("bfs64"), SEED,
                        spans.Spans(), sample).keys

    d = keys()
    assert len(set(d)) == len(d) == 64
    assert all(dep.degree[k] >= 1 for k in d)
    assert keys() == d
