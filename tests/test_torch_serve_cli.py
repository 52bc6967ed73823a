"""The port's serve and export mains (mgproto_tpu_torch/cli/{serve,export}.py)
against the JAX package's, on the CPU.

One tiny JAX state is exported by the JAX package (StableHLO, calibrated by
its `calibrate_from_config` on a seeded JPEG folder, with its explain
program) and carried into the port, whose export main writes the port's
artifact from a checkpoint of it (calibrated on the same folder). Both
packages' `cli.serve.main` then answer the same --images batch and the
same --stdin JSONL (valid lines, malformed JSON, a line without an image,
a bad shape): the ids, outcomes, reasons and classes must be equal line for
line, log p(x) within 1e-5 (the packages' CPU convolutions differ by
~1e-6 here), the explanations' prototypes equal and their log-densities
within 1e-5, and the summary lines must carry the same keys. The replica
plane's face (`--replicas 2 --swap`) refuses an uncalibrated swap target
and commits a calibrated one on both. Then the port alone: the checkpoint
face (`--checkpoint --calibrate`) serves what the artifact serves, bit for
bit, with the state's digest; every serve and export flag the port does not
implement raises `NotPortedError` with its ROADMAP item; `--trace_requests`
puts a timing breakdown on every response and `--profile_warmup` writes
the warmup's capture (the counted cost of each bucket on the CPU); `--help` runs with
JAX blocked; and the network face as a process (`--listen`, two replicas):
predict, the probes, /metrics, a refused and a committed swap, then a
SIGTERM with requests queued: each answered typed, exit 0.
"""

import functools
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_jax_states import port_state, write_jpeg_tree
from test_torch_cli import PROFILER_ARGVS, REFUSED_ARGVS
from mgproto_tpu.cli import serve as jserve
from mgproto_tpu.config import DataConfig as JaxDataConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine import export as jexport
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.serving import calibration as jcal
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.cli import common as tcommon
from mgproto_tpu_torch.cli import export as texport
from mgproto_tpu_torch.cli import serve as tserve
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.serving import metrics as tmetrics
from mgproto_tpu_torch.utils.checkpoint import save_checkpoint, state_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
IMG = 32
TINY = ["--arch", "tiny", "--img_size", "32", "--num_classes", "4", "--protos_per_class", "3",
        "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
        "--no_pretrained", "--batch_size", "6", "--num_workers", "0"]


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    yield
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


@functools.lru_cache(maxsize=None)
def _states():
    cfg = jax_tiny_config()
    trainer = JaxTrainer(cfg, steps_per_epoch=1)
    state = trainer.init_state(jax.random.PRNGKey(1))
    return trainer, state, port_state(state, tiny_test_config())


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Paths: the JPEG folder, the port checkpoint, each package's
    calibrated artifact with explanations, the port's uncalibrated one,
    the batch and the stdin lines."""
    root = tmp_path_factory.mktemp("serve_cli")
    imgs = write_jpeg_tree(str(root / "imgs"), 4, 5, seed=3)
    jtrainer, jstate, (trainer, state) = _states()
    run = str(root / "run")
    ckpt = save_checkpoint(run, state, "2prune0.5000", metadata={"epoch": 2, "stage": "prune"})
    data = ["--train_dir", imgs, "--test_dir", imgs, "--push_dir", imgs, "--model_dir", run]
    port = str(root / "t.mgproto")
    texport.main(TINY + data + ["--device", "cpu", "--out", port, "--calibrate", "--explain",
                                "--explain_top", "4"])
    uncal = str(root / "u.mgproto")
    texport.main(TINY + data + ["--device", "cpu", "--out", uncal])
    jcfg = jtrainer.cfg.replace(data=JaxDataConfig(
        train_dir=imgs, test_dir=imgs, train_push_dir=imgs, train_batch_size=6,
        test_batch_size=6, train_push_batch_size=6, num_workers=0))
    jpath = str(root / "j.mgproto")
    jexport.save_artifact(
        jpath, jexport.export_eval(jtrainer, jstate),
        jexport.artifact_meta(jcfg, None, True, gmm_fingerprint=jcal.gmm_fingerprint(jstate.gmm)),
        calibration=jcal.calibrate_from_config(jcfg, jtrainer, jstate),
        explain=(jexport.export_explain(jtrainer, jstate, top_e=4),
                 jexport.explain_table(jstate)))
    juncal = str(root / "ju.mgproto")
    jexport.save_artifact(juncal, jexport.export_eval(jtrainer, jstate),
                          jexport.artifact_meta(jcfg, None, True))
    x = np.random.default_rng(5).normal(size=(7, IMG, IMG, 3)).astype(np.float32)
    npy = str(root / "x.npy")
    np.save(npy, x)
    stdin = "\n".join([
        json.dumps({"id": "s0", "image": x[0].tolist()}),
        "{not json",
        json.dumps({"id": "s2", "no_image": 1}),
        json.dumps({"id": "s3", "image": [[0.0, 1.0]]}),
        "",
        json.dumps({"image": x[1].tolist()}),
    ]) + "\n"
    return dict(imgs=imgs, run=run, ckpt=ckpt, port=port, uncal=uncal, jax=jpath, juncal=juncal,
                npy=npy, stdin=stdin, x=x, data=data)


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines() if ln.startswith("{")]


def _run_both(capsys, monkeypatch, a, port_args, jax_args, stdin=None):
    got = {}
    for name, main, argv in (("jax", jserve.main, ["--arch", "tiny"] + jax_args),
                             ("torch", tserve.main, ["--device", "cpu"] + port_args)):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        capsys.readouterr()
        main(argv)
        got[name] = _lines(capsys.readouterr().out)
    return got["jax"], got["torch"]


def _compare(jl, tl, explain=False):
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        if j.get("summary"):
            # the port's summary adds its process start split
            assert set(t) == set(j) | {"start_split"}
            assert {k: t[k] for k in ("requests", "outcomes", "degraded", "warmup_compiles",
                                      "steady_state_recompiles")} == \
                {k: j[k] for k in ("requests", "outcomes", "degraded", "warmup_compiles",
                                   "steady_state_recompiles")}
            continue
        if j.get("swap"):
            assert (t["ok"], t["reason"], t["replicas_swapped"]) == \
                (j["ok"], j["reason"], j["replicas_swapped"])
            continue
        assert set(t) == set(j)
        for k in ("request_id", "outcome", "reason", "prediction", "trust", "degraded"):
            assert t[k] == j[k], (k, t, j)
        if j["log_px"] is not None:
            assert abs(t["log_px"] - j["log_px"]) <= ATOL
        if explain and j.get("explain"):
            assert [r["prototype"] for r in t["explain"]] == \
                [r["prototype"] for r in j["explain"]]
            for rt, rj in zip(t["explain"], j["explain"]):
                assert abs(rt["log_density"] - rj["log_density"]) <= ATOL
                assert (rt["class"], rt["k"], rt["prior"]) == (rj["class"], rj["k"], rj["prior"])


def test_images_face_matches_jax(artifacts, capsys, monkeypatch):
    a = artifacts
    jl, tl = _run_both(capsys, monkeypatch, a, ["--artifact", a["port"], "--images", a["npy"]],
                       ["--artifact", a["jax"], "--images", a["npy"]])
    _compare(jl, tl)
    assert [r["request_id"] for r in tl[:-1]] == [f"x.npy[{i}]" for i in range(7)]
    assert tl[-1]["warmup_compiles"] == 4 and tl[-1]["steady_state_recompiles"] == 0
    assert all(r["outcome"] in ("predict", "abstain") for r in tl[:-1])


def test_stdin_face_matches_jax_with_typed_rejects(artifacts, capsys, monkeypatch):
    a = artifacts
    jl, tl = _run_both(capsys, monkeypatch, a, ["--artifact", a["port"], "--stdin"],
                       ["--artifact", a["jax"], "--stdin"], stdin=a["stdin"])
    _compare(jl, tl)
    assert [(r["request_id"], r["outcome"], r["reason"]) for r in tl[:-1]] == [
        ("s0", tl[0]["outcome"], None), ("stdin[1]", "reject", "bad_dtype"),
        ("stdin[2]", "reject", "bad_dtype"), ("s3", "reject", "bad_shape"),
        ("stdin[5]", tl[4]["outcome"], None)]


def test_explanations_served_match_jax(artifacts, capsys, monkeypatch):
    a = artifacts
    jl, tl = _run_both(capsys, monkeypatch, a,
                       ["--artifact", a["port"], "--images", a["npy"], "--explain"],
                       ["--artifact", a["jax"], "--images", a["npy"], "--explain"])
    _compare(jl, tl, explain=True)
    assert any(len(r.get("explain") or ()) == 4 for r in tl)


@pytest.mark.parametrize("target", ["uncalibrated", "calibrated"])
def test_replica_plane_swap_face_matches_jax(artifacts, capsys, monkeypatch, target):
    a = artifacts
    tgt = {"uncalibrated": (a["uncal"], a["juncal"]), "calibrated": (a["port"], a["jax"])}[target]
    jl, tl = _run_both(
        capsys, monkeypatch, a,
        ["--artifact", a["port"], "--images", a["npy"], "--replicas", "2", "--swap", tgt[0]],
        ["--artifact", a["jax"], "--images", a["npy"], "--replicas", "2", "--swap", tgt[1]])
    _compare(jl, tl)
    swaps = [ln for ln in tl if ln.get("swap")]
    assert [s["reason"] for s in swaps] == ["uncalibrated" if target == "uncalibrated"
                                            else "committed"]
    assert tl[-1]["replicas"] == 2 and tl[-1]["replicas_ready"] == 2


def test_swap_keeps_the_fleets_percentile(artifacts, capsys, monkeypatch):
    """`--percentile 50 --replicas 2 --swap`: the trust labels equal the JAX
    package's line for line, and the green fleet (each standby, every later
    restart) gates at the 50th percentile, not at the artifact's own."""
    import argparse

    from mgproto_tpu_torch.engine.export import load_artifact

    a = artifacts
    jl, tl = _run_both(
        capsys, monkeypatch, a,
        ["--artifact", a["port"], "--images", a["npy"], "--replicas", "2", "--swap", a["port"],
         "--percentile", "50"],
        ["--artifact", a["jax"], "--images", a["npy"], "--replicas", "2", "--swap", a["jax"],
         "--percentile", "50"])
    _compare(jl, tl)
    assert [ln["reason"] for ln in tl if ln.get("swap")] == ["committed"]
    assert [r["trust"] for r in tl if "trust" in r] == [r["trust"] for r in jl if "trust" in r]
    args = argparse.Namespace(device="cpu", percentile=50.0, allow_uncalibrated=False,
                              explain=False, buckets="1,2,4,8", queue_capacity=64,
                              deadline_ms=0.0)
    cal = load_artifact(a["port"], device="cpu").calibration
    assert cal.percentile != 50.0
    factory = tserve._swap_factory(args, a["port"])
    for _ in range(2):  # a standby, then a restart from the retargeted factory
        assert factory().gate.threshold == cal.threshold_for(50.0) != cal.threshold_log_px


def test_checkpoint_face_serves_what_the_artifact_serves(artifacts, capsys):
    a = artifacts
    tserve.main(["--device", "cpu", "--artifact", a["port"], "--images", a["npy"]])
    art = _lines(capsys.readouterr().out)
    tserve.main(TINY + a["data"] + ["--device", "cpu", "--checkpoint", a["ckpt"], "--calibrate",
                                    "--images", a["npy"]])
    live = _lines(capsys.readouterr().out)
    assert [{k: v for k, v in r.items() if k != "latency_s"} for r in live[:-1]] == \
        [{k: v for k, v in r.items() if k != "latency_s"} for r in art[:-1]]
    assert set(live[-1]) == set(art[-1]) | {"state_digest"}
    assert live[-1]["state_digest"] == state_digest(_states()[2][1])
    with pytest.raises(SystemExit, match="--calibrate"):
        tserve.main(TINY + a["data"] + ["--device", "cpu", "--checkpoint", a["ckpt"]])


def test_the_artifact_face_refuses_a_jax_artifact_and_an_uncalibrated_one(artifacts):
    from mgproto_tpu_torch.engine.export import ArtifactFormatError
    from mgproto_tpu_torch.serving.engine import UncalibratedArtifactError

    with pytest.raises(ArtifactFormatError, match="JAX artifact"):
        tserve.main(["--device", "cpu", "--artifact", artifacts["jax"]])
    with pytest.raises(UncalibratedArtifactError):
        tserve.main(["--device", "cpu", "--artifact", artifacts["uncal"]])


@pytest.fixture(scope="module")
def online_ckpts(artifacts, tmp_path_factory):
    """A JAX checkpoint of the JAX state beside the port's checkpoint of it,
    and an npy of the folder's own images (in distribution, so the capture
    gate passes some)."""
    from mgproto_tpu.utils.checkpoint import save_checkpoint as jsave
    from mgproto_tpu_torch.data.folder import ImageFolder
    from mgproto_tpu_torch.data.transforms import test_transform

    root = tmp_path_factory.mktemp("serve_online")
    jrun = str(root / "jrun")
    jckpt = jsave(jrun, _states()[1], "2prune0.5000", metadata={"epoch": 2, "stage": "prune"})
    ds = ImageFolder(artifacts["imgs"], test_transform(IMG))
    npy = str(root / "folder.npy")
    np.save(npy, np.stack([ds.load(i)[0] for i in range(len(ds))]).astype(np.float32))
    return dict(jckpt=jckpt, jrun=jrun, npy=npy)


@pytest.mark.parametrize("flags", [
    [],
    ["--online_capture_percentile", "10"],
    ["--online_capture_capacity", "1"],
    ["--online_cadence_s", "0"],
], ids=["online", "capture_percentile", "capture_capacity", "cadence_s"])
def test_online_on_the_checkpoint_face_matches_jax(artifacts, online_ckpts, capsys, monkeypatch,
                                                    flags):
    """`--online` with each of its knobs on the checkpoint face with
    --calibrate, both packages on the same state and images: the responses
    as `_compare` holds them, and the summary's online block (the capture's
    decisions, the consolidation's runs and samples) equal; the tap is
    uninstalled after. The cadence is an hour but in its own case (0: a
    tick every pump turn), so no tick depends on how fast the machine is."""
    from mgproto_tpu_torch.online import capture as tcapture

    a, o = artifacts, online_ckpts
    common = TINY[2:] + ["--train_dir", a["imgs"], "--test_dir", a["imgs"], "--push_dir",
                         a["imgs"], "--calibrate", "--online", "--online_cadence_s", "3600",
                         "--images", o["npy"]] + flags
    jl, tl = _run_both(capsys, monkeypatch, a,
                       common + ["--arch", "tiny", "--model_dir", a["run"], "--checkpoint",
                                 a["ckpt"]],
                       common + ["--model_dir", o["jrun"], "--checkpoint", o["jckpt"]])
    _compare(jl[:-1], tl[:-1])
    assert set(tl[-1]) == set(jl[-1]) | {"start_split", "state_digest"}
    jo, to = jl[-1]["online"], tl[-1]["online"]
    assert set(to) == set(jo) and to["consolidation"] == jo["consolidation"]
    jcap, tcap = jo["capture"], to["capture"]
    assert abs(tcap.pop("threshold_log_px") - jcap.pop("threshold_log_px")) <= ATOL
    assert tcap == jcap
    samples = to["consolidation"]["samples"]
    assert 0 < samples <= tcap["accepted"]
    if "--online_capture_capacity" in flags:  # a full queue drops or displaces
        assert samples < tcap["accepted"]
    else:
        assert samples == tcap["accepted"]
    assert tcapture.get_active() is None


def test_online_is_refused_on_the_artifact_face_and_with_listen(artifacts):
    """As in the JAX package: the artifact face has no bank to consolidate
    into, and the network face does not tick the cadence."""
    import argparse

    a = artifacts
    with pytest.raises(SystemExit, match="live checkpoint face"):
        tserve.main(["--device", "cpu", "--artifact", a["port"], "--images", a["npy"],
                     "--online"])
    for main in (tserve.main, jserve.main):
        with pytest.raises(SystemExit):
            main(["--online", "--listen", "127.0.0.1:0", "--allow-uncalibrated",
                  "--artifact", "x.mgproto"])
    with pytest.raises(SystemExit, match="needs a calibration"):
        fac = lambda: None  # noqa: E731
        fac.live_context = (None, None, None)
        tserve._setup_online(argparse.Namespace(online=True), fac)
    with pytest.raises(SystemExit):
        jserve._setup_online(argparse.Namespace(online=True), lambda: None, None)


SERVE_ARGVS = {
    "aot_cache": (["--aot-cache", "auto"], "A7"),
}
EXPORT_ARGVS = {
    "aot_cache": (["--aot-cache"], "A7"),
    "aot_buckets": (["--aot_buckets", "1,2"], "A7"),
}


def test_every_refused_serve_and_export_flag_has_a_case():
    assert {d for d, _, _ in tcommon.SERVE_REFUSED} == set(SERVE_ARGVS)
    assert {d for d, _, _ in tcommon.EXPORT_REFUSED} == set(EXPORT_ARGVS)


@pytest.mark.parametrize("main,dest", [("serve", d) for d in sorted(SERVE_ARGVS)]
                         + [("export", d) for d in sorted(EXPORT_ARGVS)])
def test_unported_serve_and_export_flags_are_refused(main, dest, tmp_path):
    argv, item = (SERVE_ARGVS if main == "serve" else EXPORT_ARGVS)[dest]
    fn = tserve.main if main == "serve" else texport.main
    extra = ["--out", str(tmp_path / "o.mgproto")] if main == "export" else []
    with pytest.raises(tcommon.NotPortedError, match=f"--{dest}=.*ROADMAP {item}"):
        fn(["--device", "cpu", "--artifact" if main == "serve" else "--model_dir",
            str(tmp_path / "none")] + extra + argv)
    # the JAX mains take the same flag
    jp = {"serve": jserve, "export": __import__("mgproto_tpu.cli.export", fromlist=["x"])}[main]
    assert f"--{dest}".replace("_", "-") in open(jp.__file__).read().replace("_", "-")


@pytest.mark.parametrize("dest", ["trace_requests", "profile_warmup"])
def test_the_observatory_serve_flags_work(dest, artifacts, capsys, tmp_path):
    """--trace_requests and --profile_warmup (refused before the observatory
    was ported) on the batch face: every answered line carries its stage
    timings; the warmup's CPU capture holds the counted cost of one
    dispatch a bucket."""
    from mgproto_tpu_torch.obs import reqtrace
    from mgproto_tpu_torch.obs.profiler import COST_FILE, META_FILE

    a = artifacts
    flag = ["--trace_requests"] if dest == "trace_requests" else [
        "--profile_warmup", str(tmp_path / "warm")]
    tserve.main(["--device", "cpu", "--artifact", a["port"], "--images", a["npy"]] + flag)
    lines = _lines(capsys.readouterr().out)
    answered = [r for r in lines[:-1] if r["outcome"] in ("predict", "abstain")]
    assert answered
    if dest == "trace_requests":
        for r in answered:
            t = r["timings"]
            assert t["total_s"] >= t["queue_s"] >= 0.0 and t["device_s"] >= 0.0
        assert not reqtrace.enabled()  # the main turns it off again
    else:
        assert all("timings" not in r for r in lines[:-1])
        (cap,) = os.listdir(tmp_path / "warm")
        meta = json.load(open(tmp_path / "warm" / cap / META_FILE))
        assert meta["reason"] == "serve_warmup" and meta["fallback"] is True
        costs = json.load(open(tmp_path / "warm" / cap / COST_FILE))
        assert costs["buckets"] == [1, 2, 4, 8] and set(costs["programs"]) == {
            "b1", "b2", "b4", "b8"}
        flops = [costs["programs"][f"b{b}"]["flops"] for b in (1, 2, 4, 8)]
        assert flops[0] > 0 and flops == [flops[0] * b for b in (1, 2, 4, 8)]


@pytest.mark.parametrize("main,dest", [(m, d) for m in ("serve", "export")
                                         for d in sorted(PROFILER_ARGVS)])
def test_serve_and_export_take_the_profiler_training_flags(main, dest, tmp_path):
    """Both mains parse the training parser's profiler flags (refused
    before the observatory was ported) and pass them, as JAX's mains do
    (they profile no training run): what stops them is the missing input,
    not a NotPortedError."""
    fn = tserve.main if main == "serve" else texport.main
    extra = ["--out", str(tmp_path / "o.mgproto")] if main == "export" else []
    with pytest.raises((Exception, SystemExit)) as e:
        fn(["--device", "cpu", "--artifact" if main == "serve" else "--model_dir",
            str(tmp_path / "none")] + extra + PROFILER_ARGVS[dest][0])
    assert not isinstance(e.value, tcommon.NotPortedError), e.value


@pytest.mark.parametrize("main,dest", [(m, d) for m in ("serve", "export")
                                         for d in sorted(REFUSED_ARGVS)])
def test_serve_and_export_refuse_the_unported_training_flags(main, dest, tmp_path):
    """Both mains parse every training flag; each of `REFUSED` is refused
    before anything loads, never ignored."""
    argv, item = REFUSED_ARGVS[dest]
    fn = tserve.main if main == "serve" else texport.main
    extra = ["--out", str(tmp_path / "o.mgproto")] if main == "export" else []
    with pytest.raises(tcommon.NotPortedError, match=f"--{dest}=.*ROADMAP {item}"):
        fn(["--device", "cpu", "--artifact" if main == "serve" else "--model_dir",
            str(tmp_path / "none")] + extra + argv)


BLOCKER = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['mgproto_tpu'] = None; "
           "sys.argv = [sys.argv[1], '--help']; "
           "runpy.run_module(sys.argv[0], run_name='__main__')")


@pytest.mark.parametrize("main", ["serve", "export"])
def test_help_runs_without_jax(main):
    r = subprocess.run([sys.executable, "-c", BLOCKER, f"mgproto_tpu_torch.cli.{main}"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "usage:" in r.stdout


def _request(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data)
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


@pytest.mark.parametrize("flags,replicas", [(["--autoscale", "1:3"], 1),
                                           (["--autoscale", "2:3", "--autoscale_interval_s",
                                             "0.05"], 2)])
def test_network_face_autoscales(artifacts, flags, replicas):
    """`--autoscale MIN:MAX` and `--autoscale_interval_s` (refused before
    the autoscaler was ported): the banner names the bounds, `--replicas 1`
    starts clamped into them, GET /admin/autoscale reports the
    autoscaler's status, requests are served, SIGTERM drains, exit 0."""
    a = artifacts
    proc = subprocess.Popen(
        [sys.executable, "-m", "mgproto_tpu_torch.cli.serve", "--device", "cpu", "--artifact",
         a["port"], "--listen", "127.0.0.1:0", "--replicas", "1"] + flags,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        import select

        assert select.select([proc.stdout], [], [], 120)[0], "no banner within 120 s"
        banner = json.loads(proc.stdout.readline())
        port = banner["port"]
        assert banner["autoscale"] == flags[1] and banner["replicas"] == replicas
        s, body = _request(port, "GET", "/admin/autoscale")
        status = json.loads(body)
        assert s == 200 and (status["min_replicas"], status["max_replicas"]) == \
            tuple(int(v) for v in flags[1].split(":"))
        assert status["replicas"] == replicas
        s, body = _request(port, "POST", "/v1/predict", {"id": "p0", "image": a["x"][0].tolist()})
        assert s == 200 and json.loads(body)["request_id"] == "p0"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["outcomes"] == {"predict": 1}


def test_network_face_swaps_and_drains_typed_on_sigterm(artifacts):
    a = artifacts
    proc = subprocess.Popen(
        [sys.executable, "-m", "mgproto_tpu_torch.cli.serve", "--device", "cpu", "--artifact",
         a["port"], "--listen", "127.0.0.1:0", "--replicas", "2", "--linger_ms", "600000"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        port = banner["port"]
        assert banner["listening"] and banner["replicas"] == 2 and banner["warmup_compiles"] == 8
        assert _request(port, "GET", "/healthz")[0] == 200
        s, body = _request(port, "GET", "/readyz")
        assert s == 200 and len(json.loads(body)["replicas"]) == 2
        assert _request(port, "POST", "/admin/swap", {"artifact": a["uncal"]})[0] == 409
        s, body = _request(port, "POST", "/admin/swap", {"artifact": a["port"]})
        assert s == 200 and json.loads(body)["replicas_swapped"] == 2
        # requests stay queued (linger of 10 minutes, under the largest
        # bucket) until the SIGTERM's drain answers them through the model
        results = {}

        def send(i):
            results[i] = _request(port, "POST", "/v1/predict",
                                  {"id": f"q{i}", "image": a["x"][i].tolist()})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for _ in range(600):
            s, body = _request(port, "GET", "/metrics")
            if b'serving_queue_depth 3' in body:
                break
        assert b'serving_queue_depth 3' in body
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(60)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    answered = {json.loads(b)["request_id"]: (s, json.loads(b)["outcome"])
                for s, b in results.values()}
    assert answered == {f"q{i}": (200, "predict") for i in range(3)}
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["drained"] and summary["outcomes"] == {"predict": 3}
    assert summary["steady_state_recompiles"] == 0 and summary["json_decode_s"]["count"] == 3
