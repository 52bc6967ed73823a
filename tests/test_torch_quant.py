"""The port's int8 weight-only serving (mgproto_tpu_torch/perf/quant.py,
models/quantized.py, engine/export.py, cli/export.py --quantize, and the
quant rule of serving/{gate,swap,engine,tenants}.py) against the JAX
package's, on the CPU.

One tiny JAX state (PRNGKey(0)) is quantized by the JAX package
(`quantize_params`) and, carried by `from_jax_train_state`, by the port
(`quantize_model`). Held: the policy's refusals; the int8 values and the
scales bit-equal to JAX's after the layout transpose (the port's output
channel is axis 0, JAX's the last); the quantized set, the `quant_config`
block (but `fingerprint`, the port's own) and the shape-math report equal
to JAX's; the artifacts (`--quantize none` byte for byte as before, int8
tensors only for the quantized weights, a tampered weight refused); the two
packages' int8 artifacts within 1e-5 on logits and log p(x) (the tolerance
of test_torch_export.py), and the port's int8 model bit-equal to its
dequantize-on-load twin in f32 and in bf16; JAX's gate matrix and
`verify_head` precedence on both gates side by side; the engine, the
tenants and the export main; and where the word int8 may appear in the
port.
"""

import ast
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import port_state, write_jpeg_tree
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine import export as jexport
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.perf import quant as jquant
from mgproto_tpu.serving import calibration as jcal
from mgproto_tpu.serving import gate as jgate
from mgproto_tpu.serving import metrics as jsm
from mgproto_tpu.serving import swap as jswap
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import default_registry as jax_registry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.cli import export as texport_main
from mgproto_tpu_torch.config import Config, DataConfig, tiny_test_config
from mgproto_tpu_torch.core.mgproto import build_mgproto, make_features
from mgproto_tpu_torch.engine import export as texport
from mgproto_tpu_torch.engine.eval import Evaluator, eval_mode
from mgproto_tpu_torch.models import convert as tconvert
from mgproto_tpu_torch.models import quantized as tquantized
from mgproto_tpu_torch.perf import quant as tquant
from mgproto_tpu_torch.serving import calibration as tcal
from mgproto_tpu_torch.serving import gate as tgate
from mgproto_tpu_torch.serving import metrics as tsm
from mgproto_tpu_torch.serving import swap as tswap
from mgproto_tpu_torch.serving.engine import ServingEngine
from mgproto_tpu_torch.serving.tenants import TenantDirectory
from mgproto_tpu_torch.utils.checkpoint import save_checkpoint

ATOL = 1e-5
IMG = 32
TAG = tquant.QUANT_TAG_INT8
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "mgproto_tpu_torch")


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_t = tsm.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    yield
    jax_set_registry(prev_j)
    tsm.set_current_registry(prev_t)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jax_tiny_config()
    trainer = JaxTrainer(cfg, steps_per_epoch=1)
    return trainer, trainer.init_state(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port():
    """(port trainer, the JAX state carried into the port)."""
    return port_state(_jax()[1], tiny_test_config())


@functools.lru_cache(maxsize=None)
def _jq():
    return jquant.quantize_params(_jax()[1].params)


@functools.lru_cache(maxsize=None)
def _tq():
    trainer, state = _port()
    return tquant.quantize_model(state.model, proxies=state.proxies)


def _port_name(jax_path):
    """A JAX report path ("net/features/conv0/kernel") -> the port's name."""
    parts = tuple(jax_path.split("/"))
    if parts == ("proxies",):
        return "proxies"
    return tconvert._weight_name(parts[1:], np.zeros((1, 1)))[0]


def _to_port_layout(w):
    """JAX [kh, kw, I, O] / [I, O] -> the port's [O, I, kh, kw] / [O, I]."""
    w = np.asarray(w)
    return w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T


def _to_jax_layout(w):
    w = np.asarray(w)
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def _calib(pkg, quant="", fingerprint="fp0", classes=3):
    scores = np.linspace(-30.0, -10.0, 64)
    logits = np.tile(scores[:, None], (1, classes))
    cal = tcal if pkg == "torch" else jcal
    return cal.Calibration.from_scores(scores, logits, fingerprint=fingerprint,
                                       quant_config=quant)


# ------------------------------------------------------------------ (a) policy
@pytest.mark.parametrize("kw", [{"mode": "int4"}, {"mode": "int8", "granularity": "per_tensor"},
                                {"mode": "int8", "symmetric": False},
                                {"mode": "int8", "gmm_dtype": "int8"},
                                {"mode": "int8", "score_dtype": "int8"},
                                {"mode": "int8", "calibration_dtype": "int8"}],
                         ids=["mode", "granularity", "symmetric", "gmm", "score", "calibration"])
def test_policy_refuses_what_jax_refuses(kw):
    with pytest.raises(jquant.QuantError) as want:
        jquant.QuantPolicy(**kw)
    with pytest.raises(tquant.QuantError) as got:
        tquant.QuantPolicy(**kw)
    assert str(got.value) == str(want.value)


def test_policy_names_tag_and_resolution_equal_jax():
    for name in ("QUANT_FORMAT", "SUPPORTED_QUANT_MODES", "QUANT_TAG_INT8"):
        assert getattr(tquant, name) == getattr(jquant, name)
    for mode in ("", "none", "int8"):
        t, j = tquant.resolve_quant_policy(mode), jquant.resolve_quant_policy(mode)
        assert (t.mode, t.quantized, t.tag) == (j.mode, j.quantized, j.tag)
    assert tquant.QuantPolicy().tag == "" and tquant.QuantPolicy(mode="int8").tag == TAG


# ------------------------------------------------------------------ (b) arrays
SHAPES = {"conv3x3": (3, 3, 4, 8), "conv1x1": (1, 1, 16, 8), "dense": (5, 4)}


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_quantize_array_is_bit_equal_to_jax_after_the_transpose(kind):
    w = np.random.default_rng(len(kind)).normal(size=SHAPES[kind]).astype(np.float32)
    jq, jscale = jquant.quantize_array(w)
    q, scale = tquant.quantize_array(_to_port_layout(w))
    assert q.dtype == np.int8 and scale.dtype == np.float32 and scale.shape == (w.shape[-1],)
    np.testing.assert_array_equal(q, _to_port_layout(jq))
    assert scale.tobytes() == jscale.tobytes()
    # the same input as a tensor quantizes the same way
    qt, st = tquant.quantize_array(torch.from_numpy(_to_port_layout(w).copy()))
    np.testing.assert_array_equal(qt, q)
    assert st.tobytes() == scale.tobytes()


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_dead_channel_and_round_trip_bound(kind):
    w = _to_port_layout(np.random.default_rng(3).normal(size=SHAPES[kind]).astype(np.float32))
    w = np.ascontiguousarray(w)
    w[2] = 0.0
    q, scale = tquant.quantize_array(w)
    assert scale[2] == 1.0
    back = tquant.dequantize_array(q, scale)
    np.testing.assert_array_equal(back[2], np.zeros_like(w[2]))
    bound = scale.reshape((-1,) + (1,) * (w.ndim - 1)) * 0.5 + 1e-7
    assert np.all(np.abs(back - w) <= bound)
    assert int(np.abs(q).max()) == 127
    np.testing.assert_array_equal(
        back, _to_port_layout(jquant.dequantize_array(_to_jax_layout(q), scale)))


# ------------------------------------------------------------- (c) the state
def test_quantized_set_maps_onto_jax_and_values_are_bit_equal():
    jq, tq = _jq(), _tq()
    jrows = {_port_name(r["path"]): r for r in jq.report}
    trows = {r["path"]: r for r in tq.report}
    assert set(jrows) == set(trows)
    for name, row in trows.items():
        assert row["quantized"] == jrows[name]["quantized"], name
        assert (row["f32_bytes"], row["quant_bytes"]) == (jrows[name]["f32_bytes"],
                                                         jrows[name]["quant_bytes"]), name
    assert {n for n, r in trows.items() if r["quantized"]} == {
        f"{n}.weight" for n, m in _port()[1].model.named_modules() if tquantized.is_quantizable(m)}
    # the int8 values and scales, module by module
    jpairs = {_port_name(r["path"]): e for r, e in zip(jq.report, jq.entries)
              if r["quantized"]}
    mods = dict(tquantized.quantized_modules(tq.model))
    assert len(mods) == len(jpairs) == tq.num_quantized
    for name, mod in mods.items():
        _, q, scale = jpairs[f"{name}.weight"]
        np.testing.assert_array_equal(mod.qweight.numpy(), _to_port_layout(q))
        assert mod.scale.numpy().tobytes() == np.asarray(scale).tobytes(), name


def test_quant_config_and_bytes_equal_jax_but_the_fingerprint():
    jq, tq = _jq(), _tq()
    want, got = jq.quant_config(), tq.quant_config()
    assert {k: v for k, v in got.items() if k != "fingerprint"} == {
        k: v for k, v in want.items() if k != "fingerprint"}
    # the fingerprint is the port's own digest of its own tensors
    assert got["fingerprint"] != want["fingerprint"] and len(got["fingerprint"]) == 64
    trainer, state = _port()
    rep = tquant.weight_bytes_report(state.model, state.proxies)
    assert rep == jquant.weight_bytes_report(_jax()[1].params)
    assert rep == {"f32_bytes": tq.total_f32_bytes, "int8_bytes": tq.total_weight_bytes}
    # shapes only: the same model on the meta device
    with torch.device("meta"):
        meta_model = make_features(trainer.cfg.model, torch.device("cpu"))
    assert tquant.weight_bytes_report(meta_model, state.proxies.to("meta")) == rep
    # what the quantized model holds is what the block counts
    assert tquant.resident_weight_bytes(tq.model, state.proxies) == got["total_weight_bytes"]
    assert tquant.resident_weight_bytes(state.model, state.proxies) == got["total_f32_bytes"]


def test_fingerprint_is_deterministic_and_moves_with_the_weights():
    trainer, state = _port()
    fp = _tq().fingerprint()
    assert tquant.quantize_model(state.model, proxies=state.proxies).fingerprint() == fp
    bumped = tquant.quantize_model(state.model, proxies=state.proxies).model
    with torch.no_grad():
        for _, mod in tquantized.quantized_modules(bumped):
            mod.scale.mul_(1.1)
    assert tquant.quant_fingerprint(bumped.state_dict()) != fp
    import copy

    scaled = copy.deepcopy(state.model)
    with torch.no_grad():
        for p in scaled.parameters():
            p.mul_(1.1)
    assert tquant.quantize_model(scaled).fingerprint() != fp
    # the caller's model is left as it was; mode "none" quantizes nothing
    none = tquant.quantize_model(state.model, tquant.QuantPolicy())
    assert none.model is state.model and none.num_quantized == 0
    assert all(isinstance(p, torch.nn.Parameter) for p in state.model.parameters())
    assert not list(tquantized.quantized_modules(state.model))


def test_quantized_model_serves_only_and_keeps_its_static_shapes():
    tq = _tq()
    model = tq.model.eval()
    x = torch.from_numpy(_images(2, seed=4))
    with pytest.raises(RuntimeError, match="serves only"):
        model(x)  # autograd recording
    model.train()
    with torch.no_grad(), pytest.raises(RuntimeError, match="serves only"):
        model(x)
    model.eval()
    with torch.inference_mode(), eval_mode(_port()[1].model) as f32:
        proto_map, embed = model(x)
        want = f32(x)[0]
    assert proto_map.shape == want.shape and torch.isfinite(proto_map).all()
    # the receptive field's input is the trunk's static conv_info
    assert model.features.conv_info() == _port()[1].model.features.conv_info()


# ------------------------------------------------------------ (d) artifacts
@functools.lru_cache(maxsize=None)
def _artifacts(tmp):
    """{"f32", "int8", "jax_int8"} artifact paths of the carried state, with
    calibrations stamped as their weights are."""
    trainer, state = _port()
    cfg, fp = trainer.cfg, tcal.gmm_fingerprint(state.gmm)
    tq = _tq()
    paths = {k: os.path.join(tmp, f"{k}.mgproto") for k in ("f32", "int8", "jax_int8")}
    cal = functools.partial(_calib, "torch", fingerprint=fp, classes=cfg.model.num_classes)
    texport.save_artifact(paths["f32"], state.model, state.gmm,
                          texport.artifact_meta(cfg, None, fp), calibration=cal(""))
    texport.save_artifact(paths["int8"], tq.model, state.gmm,
                          texport.artifact_meta(cfg, None, fp, quant=tq.quant_config()),
                          calibration=cal(TAG), proxies=tq.proxies)
    jtrainer, jstate = _jax()
    jq = _jq()
    jexport.save_artifact(paths["jax_int8"], jexport.export_eval(jtrainer, jstate, quantized=jq),
                          jexport.artifact_meta(jtrainer.cfg, None, True,
                                                quant=jq.quant_config()))
    return paths


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    return _artifacts(str(tmp_path_factory.mktemp("quant")))


def test_int8_weights_hold_int8_tensors_only(arts):
    with zipfile.ZipFile(arts["int8"]) as z:
        payload = torch.load(io.BytesIO(z.read("weights.pt")), weights_only=True)
        int8_bytes = z.getinfo("weights.pt").file_size
        meta = json.loads(z.read("meta.json"))
    with zipfile.ZipFile(arts["f32"]) as z:
        f32_bytes = z.getinfo("weights.pt").file_size
        assert "quant_config" not in json.loads(z.read("meta.json"))
    sd = payload["model"]
    quantized = [r["path"][:-len(".weight")] for r in _tq().report if r["quantized"]]
    for name in quantized:
        assert f"{name}.weight" not in sd
        assert sd[f"{name}.qweight"].dtype == torch.int8
        assert sd[f"{name}.scale"].dtype == torch.float32
    assert sum(v.dtype == torch.int8 for v in sd.values()) == len(quantized)
    assert payload["proxies"].dtype == torch.float32
    assert int8_bytes < f32_bytes / 2
    assert texport.quant_tag(meta) == TAG and meta["quant_config"] == _tq().quant_config()


def test_a_tampered_int8_weight_is_refused(arts, tmp_path):
    with zipfile.ZipFile(arts["int8"]) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    payload = torch.load(io.BytesIO(entries["weights.pt"]), weights_only=True)
    q = payload["model"]["features.conv1.qweight"]
    q.view(-1)[0] = -q.view(-1)[0] if q.view(-1)[0] != 0 else 1
    buf = io.BytesIO()
    torch.save(payload, buf)
    bad = str(tmp_path / "tampered.mgproto")
    with zipfile.ZipFile(bad, "w") as z:
        for n, b in entries.items():
            z.writestr(n, buf.getvalue() if n == "weights.pt" else b)
    for dequantize in (False, True):
        with pytest.raises(texport.ArtifactFormatError, match="quant_config fingerprint"):
            texport.load_artifact(bad, device="cpu", dequantize=dequantize)


def test_dequantize_is_a_no_op_on_an_unquantized_artifact(arts):
    x = _images(3, seed=5)
    a = texport.load_artifact(arts["f32"], device="cpu")
    b = texport.load_artifact(arts["f32"], device="cpu", dequantize=True)
    assert a.proxies is None and "quant_config" not in a.meta
    for k in ("logits", "log_px"):
        np.testing.assert_array_equal(a.infer(x)[k], b.infer(x)[k])


# --------------------------------------------------- (e) cross-package parity
@pytest.mark.parametrize("batch", [2, 5])
def test_int8_artifact_matches_the_jax_int8_artifact(arts, batch):
    jinfer, jmeta = jexport.load_artifact(arts["jax_int8"])
    art = texport.load_artifact(arts["int8"], device="cpu")
    x = _images(batch, seed=10 + batch)
    want, got = jinfer(jnp.asarray(x)), art.infer(x)
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["log_px"], np.asarray(want["log_px"]), rtol=0, atol=ATOL)
    assert {k: v for k, v in art.meta["quant_config"].items() if k != "fingerprint"} == {
        k: v for k, v in jmeta["quant_config"].items() if k != "fingerprint"}
    # the int8 artifact serves the rounded weights, not the f32 ones
    f32 = texport.load_artifact(arts["f32"], device="cpu").infer(x)
    assert not np.array_equal(f32["logits"], got["logits"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_model_equals_its_dequantized_twin_bit_for_bit(tmp_path, dtype):
    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=3)
    tq = tquant.quantize_model(model)
    path = str(tmp_path / "q.mgproto")
    texport.save_artifact(path, tq.model, gmm, texport.artifact_meta(
        cfg, None, tcal.gmm_fingerprint(gmm), quant=tq.quant_config()))
    art = texport.load_artifact(path, device="cpu")
    twin = texport.load_artifact(path, device="cpu", dequantize=True)
    assert not list(tquantized.quantized_modules(twin.evaluator.model))
    assert len(list(tquantized.quantized_modules(art.evaluator.model))) == tq.num_quantized
    x = _images(4, seed=6)
    tquantized.dequantize_weight.calls = 0
    got, want = art.infer(x), twin.infer(x)
    assert tquantized.dequantize_weight.calls == tq.num_quantized
    for k in ("logits", "log_px"):
        np.testing.assert_array_equal(got[k], want[k])
    # the twin's f32 weights are the dequantized values
    sd = twin.evaluator.model.state_dict()
    for name, mod in tquantized.quantized_modules(art.evaluator.model):
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(),
                                      tquant.dequantize_array(mod.qweight.numpy(),
                                                              mod.scale.numpy()))


# ------------------------------------------------------------------- (f) gate
GATE_CASES = [  # (calibration stamp, expected_quant, degraded, quant_mismatch)
    ("", "", False, False),
    ("", TAG, True, True),
    (TAG, TAG, False, False),
    (TAG, "", True, True),
    (TAG, None, False, False),
]


@pytest.mark.parametrize("stamp,expected,degraded,mismatch", GATE_CASES)
def test_quant_gate_matrix_on_both_gates(stamp, expected, degraded, mismatch):
    gates = {"jax": jgate.TrustGate(_calib("jax", stamp), expected_fingerprint="fp0",
                                    expected_quant=expected),
             "torch": tgate.TrustGate(_calib("torch", stamp), expected_fingerprint="fp0",
                                      expected_quant=expected)}
    for g in gates.values():
        assert (g.degraded, g.quant_mismatch, g.precision_mismatch) == (degraded, mismatch,
                                                                         False)
        assert g.decide([-12.0]) == (["ungated"] if degraded else ["in_dist"])
    counts = {
        "jax": (jax_registry().counter(jsm.QUANT_MISMATCHES).value(),
                jax_registry().counter(jsm.PRECISION_MISMATCHES).value()),
        "torch": (tsm.counter(tsm.QUANT_MISMATCHES).value(),
                  tsm.counter(tsm.PRECISION_MISMATCHES).value())}
    assert counts["torch"] == counts["jax"] == (float(mismatch), 0.0)
    assert tsm.QUANT_MISMATCHES == jsm.QUANT_MISMATCHES == "serving_quant_mismatch_total"
    assert tsm.QUANT_WEIGHT_BYTES == jsm.QUANT_WEIGHT_BYTES == "serving_quant_weight_bytes"


VERIFY_CASES = [  # (expected fingerprint, calibration?, expected_quant, reason)
    ("other", True, TAG, "fingerprint_mismatch"),
    ("fp0", True, TAG, "quant_mismatch"),
    ("fp0", False, TAG, "uncalibrated"),
    ("fp0", True, "", None),
]


@pytest.mark.parametrize("fp,calibrated,expected,reason", VERIFY_CASES)
def test_verify_head_quant_precedence_equals_jax(fp, calibrated, expected, reason):
    for pkg, gate, swap in (("jax", jgate, jswap), ("torch", tgate, tswap)):
        g = gate.TrustGate(_calib(pkg) if calibrated else None, expected_fingerprint=fp,
                           expected_quant=expected)
        assert swap.verify_head(g) == reason, pkg
        if reason == "fingerprint_mismatch":
            assert g.fingerprint_mismatch and not g.quant_mismatch
    assert tswap.REJECT_QUANT == jswap.REJECT_QUANT == "quant_mismatch"


def test_calibration_stamp_round_trips():
    cal = _calib("torch", TAG)
    assert tcal.Calibration.from_json(cal.to_json()).quant_config == TAG
    d = json.loads(cal.to_json())
    del d["quant_config"]
    assert tcal.Calibration.from_dict(d).quant_config == ""
    # the JSON is JAX's: each package reads the other's stamp
    assert jcal.Calibration.from_json(cal.to_json()).quant_config == TAG
    assert tcal.Calibration.from_json(_calib("jax", TAG).to_json()).quant_config == TAG


# ------------------------------------------------------ (g) engine and tenants
def test_from_artifact_gates_int8_and_refuses_a_grafted_f32_calibration(arts, tmp_path):
    eng = ServingEngine.from_artifact(arts["int8"], device="cpu", buckets=(2,))
    assert not eng.gate.degraded and not eng.gate.quant_mismatch and eng.quant_config == TAG
    assert tsm.gauge(tsm.QUANT_WEIGHT_BYTES).value() == _tq().total_weight_bytes
    eng.warmup()
    resps = eng.serve_all(list(_images(3, seed=8)))
    assert all(r.outcome in ("predict", "abstain") and not r.degraded for r in resps)
    grafted = str(tmp_path / "grafted.mgproto")
    shutil.copy(arts["int8"], grafted)
    with zipfile.ZipFile(arts["f32"]) as z:
        texport.embed_calibration(grafted, json.loads(z.read("calibration.json")))
    eng = ServingEngine.from_artifact(grafted, device="cpu")
    assert eng.gate.degraded and eng.gate.quant_mismatch and not eng.gate.precision_mismatch
    assert tsm.counter(tsm.QUANT_MISMATCHES).value() == 1
    assert tsm.counter(tsm.PRECISION_MISMATCHES).value() == 0
    assert tswap.verify_head(eng.gate) == tswap.REJECT_QUANT
    # the f32 artifact keeps its gauge at zero and gates its own calibration
    tsm.set_current_registry(None)
    eng = ServingEngine.from_artifact(arts["f32"], device="cpu")
    assert not eng.gate.degraded and eng.quant_config == ""
    assert tsm.gauge(tsm.QUANT_WEIGHT_BYTES).value() == 0


def test_from_live_refuses_an_int8_stamped_calibration():
    trainer, state = _port()
    ev = Evaluator(state.model, state.gmm, trainer.cfg, device="cpu")
    fp = tcal.gmm_fingerprint(state.gmm)
    eng = ServingEngine.from_live(ev, calibration=_calib("torch", TAG, fp, 4))
    assert eng.gate.degraded and eng.gate.quant_mismatch and not eng.gate.precision_mismatch
    assert tsm.counter(tsm.QUANT_MISMATCHES).value() == 1
    assert tsm.counter(tsm.PRECISION_MISMATCHES).value() == 0
    assert not ServingEngine.from_live(ev, calibration=_calib("torch", "", fp, 4)).gate.degraded


def test_a_tenant_swap_of_an_unstamped_head_is_refused_for_that_tenant_only(arts):
    art = texport.load_artifact(arts["int8"], device="cpu")
    fp, tag = art.meta["gmm_fingerprint"], texport.quant_tag(art.meta)
    d = TenantDirectory()
    for name in ("a", "b"):
        d.mount(name, _calib("torch", TAG, fp, 4), expected_fingerprint=fp, expected_quant=tag)
    eng = ServingEngine.from_loaded(art, tenants=d, buckets=(2,))
    eng.warmup()
    old = d.gate_for("a")
    rep = d.swap("a", _calib("torch", "", fp, 4), expected_fingerprint=fp, expected_quant=tag)
    assert not rep.ok and rep.reason == tswap.REJECT_QUANT
    assert d.gate_for("a") is old and not old.degraded
    ok = d.swap("b", _calib("torch", TAG, fp, 4), expected_fingerprint=fp, expected_quant=tag)
    assert ok.ok
    x = _images(2, seed=9)
    for i, tenant in enumerate(("a", "b")):
        assert eng.submit(x[i], request_id=f"r{i}", tenant=tenant) == []
    resps = eng.process_pending()
    assert [(r.tenant, r.degraded) for r in resps] == [("a", False), ("b", False)]
    assert tsm.counter(tsm.QUANT_MISMATCHES).value() == 1


# ------------------------------------------------------- (h) the export main
TINY_FLAGS = ["--arch", "tiny", "--img_size", "32", "--num_classes", "4", "--protos_per_class",
              "3", "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
              "--no_pretrained", "--batch_size", "6", "--num_workers", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quant_main")
    imgs = write_jpeg_tree(str(tmp / "imgs"), 4, 5, seed=4)
    run = str(tmp / "run")
    save_checkpoint(run, _port()[1], "3prune0.5000", metadata={"epoch": 3, "stage": "prune"})
    return imgs, run, tmp


def _export(run_dir, capsys, out, *extra):
    imgs, run, tmp = run_dir
    texport_main.main(TINY_FLAGS + ["--train_dir", imgs, "--test_dir", imgs, "--push_dir", imgs,
                                    "--model_dir", run, "--out", str(tmp / out), *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), str(tmp / out)


def test_export_main_int8_calibrates_through_the_rounded_weights(run_dir, capsys):
    line, path = _export(run_dir, capsys, "q.mgproto", "--quantize", "int8", "--calibrate",
                         "--explain")
    jline_keys = {"artifact", "bytes", "calibrated", "explain", "quantize", "arch",
                  "num_classes", "img_size", "dynamic_batch", "checkpoint", "gmm_fingerprint"}
    assert set(line) == jline_keys and line["quantize"] == "int8" and line["calibrated"]
    art = texport.load_artifact(path, device="cpu")
    assert art.calibration.quant_config == TAG
    assert {k: v for k, v in art.meta["quant_config"].items() if k != "fingerprint"} == {
        k: v for k, v in _jq().quant_config().items() if k != "fingerprint"}
    # the thresholds are those of the twin's scores, bit for bit
    imgs, run, _ = run_dir
    trainer = _port()[0]
    twin = texport.load_artifact(path, device="cpu", dequantize=True).evaluator.model
    tcfg = Config(model=trainer.cfg.model, data=DataConfig(
        train_dir=imgs, test_dir=imgs, train_push_dir=imgs, train_batch_size=6,
        test_batch_size=6, train_push_batch_size=6, num_workers=0))
    want = tcal.calibrate_from_config(tcfg, trainer, dataclasses.replace(_port()[1], model=twin),
                                      device="cpu")
    assert art.calibration.thresholds == want.thresholds
    assert art.calibration.quantile_log_px == want.quantile_log_px
    assert want.quant_config == "" and art.calibration.gmm_fingerprint == want.gmm_fingerprint
    # and the explain face serves from the int8 artifact
    eng = ServingEngine.from_artifact(path, explain=True, device="cpu", buckets=(2,))
    eng.warmup()
    resps = eng.serve_all(list(_images(2, seed=12)))
    assert all(r.outcome in ("predict", "abstain") and r.explain for r in resps)
    assert not eng.gate.degraded


def test_export_main_quantize_none_is_byte_identical(run_dir, capsys):
    a_line, a = _export(run_dir, capsys, "plain.mgproto")
    b_line, b = _export(run_dir, capsys, "none.mgproto", "--quantize", "none")
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist() == ["weights.pt", "meta.json"]
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name
        assert "quant_config" not in json.loads(za.read("meta.json"))
    assert a_line["quantize"] == b_line["quantize"] == "none"


@pytest.fixture(scope="module")
def served(run_dir):
    """The export main's calibrated int8 artifact with explanations, a copy
    of it carrying an unstamped calibration, and a batch."""
    imgs, run, tmp = run_dir
    path = str(tmp / "served.mgproto")
    texport_main.main(TINY_FLAGS + ["--train_dir", imgs, "--test_dir", imgs, "--push_dir", imgs,
                                    "--model_dir", run, "--out", path, "--quantize", "int8",
                                    "--calibrate", "--explain"])
    grafted = str(tmp / "served_grafted.mgproto")
    shutil.copy(path, grafted)
    cal = texport.load_calibration(path)
    texport.embed_calibration(grafted, dataclasses.replace(cal, quant_config=""))
    x = _images(5, seed=13)
    npy = str(tmp / "served.npy")
    np.save(npy, x)
    return path, grafted, npy, x


FACES = {
    "images": [],
    "explain": ["--explain"],
    "swap": ["--replicas", "2", "--swap", "SELF"],
    "swap_refused": ["--replicas", "2", "--swap", "GRAFTED"],
}


@pytest.mark.parametrize("face", sorted(FACES) + ["stdin"])
def test_cli_serve_faces_serve_an_int8_artifact(served, face, capsys, monkeypatch):
    from mgproto_tpu_torch.cli import serve as tserve

    path, grafted, npy, x = served
    if face == "stdin":
        lines = [json.dumps({"id": "s0", "image": x[0].tolist()}), "{not json",
                 json.dumps({"id": "s2", "image": x[2].tolist()})]
        monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
        argv = ["--stdin"]
    else:
        argv = ["--images", npy] + [{"SELF": path, "GRAFTED": grafted}.get(a, a)
                                    for a in FACES[face]]
    capsys.readouterr()
    tserve.main(["--device", "cpu", "--artifact", path] + argv)
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
           if ln.startswith("{")]
    resps = [r for r in out if "request_id" in r]
    want = texport.load_artifact(path, device="cpu").infer(x)["log_px"]
    rows = ([0, 2] if face == "stdin" else list(range(len(x))))
    served_rows = [r for r in resps if r["outcome"] in ("predict", "abstain")]
    assert len(served_rows) == len(rows) and not any(r["degraded"] for r in served_rows)
    np.testing.assert_allclose([r["log_px"] for r in served_rows], want[rows], rtol=0, atol=ATOL)
    if face == "stdin":
        assert [r["outcome"] for r in resps if r["request_id"] == "stdin[1]"] == ["reject"]
    if face == "explain":
        assert all(r["explain"] for r in served_rows)
    swaps = [r for r in out if r.get("swap")]
    if face.startswith("swap"):
        assert [(s["ok"], s["reason"]) for s in swaps] == (
            [(True, "committed")] if face == "swap" else [(False, "quant_mismatch")])


def test_cli_serve_network_face_serves_an_int8_artifact(served):
    """`--listen` as a process on the int8 artifact: a prediction, the
    quant gauge on /metrics, SIGTERM drains and exits 0."""
    import http.client
    import signal
    import subprocess
    import sys

    path, _, _, x = served
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    p = subprocess.Popen([sys.executable, "-m", "mgproto_tpu_torch.cli.serve", "--device", "cpu",
                          "--artifact", path, "--listen", "127.0.0.1:0"],
                         cwd=os.path.dirname(PKG), stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True, env=env)
    try:
        banner = json.loads(p.stdout.readline())
        port = banner["port"]

        def call(method, route, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request(method, route, body=body)
            r = conn.getresponse()
            out = r.status, r.read()
            conn.close()
            return out

        status, body = call("POST", "/v1/predict",
                            json.dumps({"id": "h0", "image": x[0].tolist()}).encode())
        resp = json.loads(body)
        assert status == 200 and resp["outcome"] in ("predict", "abstain") and not resp["degraded"]
        status, metrics = call("GET", "/metrics")
        total = texport.read_meta(path)["quant_config"]["total_weight_bytes"]
        assert status == 200 and f"serving_quant_weight_bytes {total}" in metrics.decode()
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


# ------------------------------------------------------------ (i) discipline
ALLOWED = {"perf/quant.py", "engine/export.py", "models/quantized.py"}
# serving/metrics.py: the quant metrics' help strings are JAX's, word for word
TEXT_ALLOWED = ALLOWED | {"serving/metrics.py"}
PROTECTED = ("core/", "serving/calibration.py", "serving/gate.py", "ops/gaussian.py")


def _int8_uses(tree):
    """Lines of int8 dtype references: `x.int8`, a bare `int8`, the string "int8"."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "int8":
            yield node.lineno
        elif isinstance(node, ast.Name) and node.id == "int8":
            yield node.lineno
        elif isinstance(node, ast.Constant) and node.value == "int8":
            yield node.lineno


def test_int8_stays_in_the_quant_modules():
    """The port's counterpart of the int8 extension of JAX's
    scripts/check_dtype_discipline.py."""
    uses, words = {}, set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, PKG).replace(os.sep, "/")
            text = open(path).read()
            lines = list(_int8_uses(ast.parse(text)))
            if lines:
                uses[rel] = lines
            if re.search(r"\bint8\b", text):
                words.add(rel)
    assert {"perf/quant.py", "models/quantized.py"} <= set(uses) <= ALLOWED, uses
    assert words <= TEXT_ALLOWED, sorted(words)
    # the word, in code or text, never in the f32 modules
    assert not [r for r in words if r.startswith(PROTECTED)], sorted(words)
    assert tsm.COUNTER_HELP[tsm.QUANT_MISMATCHES] == jsm.COUNTER_HELP[jsm.QUANT_MISMATCHES]
    # the check sees uint8 (the images' wire format) as another word
    assert not list(_int8_uses(ast.parse("x = np.uint8; y = 'uint8'")))
    assert list(_int8_uses(ast.parse("x = torch.int8")))
