"""The eval adapter on the port (aurora_tpu_torch/eval/, cli/mmbench.py)
against the JAX package's, on the CPU in float32.

- Every case of the reference's tests/test_eval.py runs on the port
  (`port_cases`: the file's source with the JAX package's eval modules
  replaced by the port's copies, AuroraCapEval on the CPU in float32):
  the VDCScore protocol against a scripted judge, post_eval, the
  evaluator end to end, multimodal loglikelihood against the HF torch
  composition (2e-3), MMBench, captions, VATEX, VideoChatGPT, VQA.
- The copies are the reference's modules, source for source, but for the
  package name, the reference checkout's path in docstrings and the CLI
  mains (which take argv); the built-in tasks
  registered and their configs are equal, and the VDC hooks give equal
  prompts, visuals, per-doc results and aggregations on the same docs.
- AuroraCapEval port vs JAX on one tiny xtuner directory and 56-pixel
  videos (the geometry is the identity on both sides): generate_batch's
  engine requests and generate_until's dense decode under the near-tie
  contract of test_torch_engine_quant.py (their logprobs recorded where
  each side samples), loglikelihood_choices within 1e-4 abs; videos that
  need a resize (PIL against the device resize, within 2/255) under the
  near-tie contract only.
- HTTPModelEval against the port's HTTP server in a thread answers what
  the port's generate_batch answers; the CLI modes test / eval /
  post-eval / mmbench run, and no ported mode exits 2.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aurora_tpu.eval.tasks  # noqa: F401  (registers the built-ins)
import aurora_tpu_torch.eval.tasks  # noqa: F401
from aurora_tpu.eval import api as japi
from aurora_tpu_torch.eval import api as tapi

from test_torch_engine_quant import NEAR_TIE, assert_near_tie_parity

TESTS = pathlib.Path(__file__).parent
REPO = TESTS.parent
LL_TOL = 1e-4


def port_cases(name: str):
    """The reference's tests/<name>, compiled to run on the port: the JAX
    package's modules named as the port's, AuroraCapEval built in float32
    on the CPU. Each replacement must apply, and no JAX name may remain."""
    src = (TESTS / name).read_text()
    subs = [("aurora_tpu.", "aurora_tpu_torch.")]
    if "import jax.numpy as jnp\n" in src:
        subs += [("import jax.numpy as jnp\n", "import torch\n"),
                 ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu")')]
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    assert "jnp." not in src and "import jax" not in src, name
    return compile(src, f"{name} (on the port)", "exec")


exec(port_cases("test_eval.py"))

# the built-in tasks, as importing the task packages registers them
# (read at import, before any test of the worker registers its own)
JAX_BUILTIN = {n: japi._REGISTRY[n] for n in japi.list_tasks()}
PORT_BUILTIN = {n: tapi._REGISTRY[n] for n in tapi.list_tasks()}

# modules whose source is the reference's but for the package name and
# the reference checkout's location in their docstrings
COPIED = ["eval/__init__.py", "eval/api.py", "eval/evaluator.py",
          "eval/judge.py", "eval/metrics.py", "eval/yaml_task.py",
          *(f"eval/tasks/{p.name}" for p in sorted(
              (REPO / "aurora_tpu" / "eval" / "tasks").glob("*.py")))]


@pytest.mark.parametrize("path", COPIED)
def test_copies_are_the_reference_modules(path):
    ref = (REPO / "aurora_tpu" / path).read_text()
    port = (REPO / "aurora_tpu_torch" / path).read_text()
    def checkout(text):         # the reference checkout's path, any root
        return re.sub(r"\S*reference/", "reference/", text)
    assert checkout(port.replace("aurora_tpu_torch", "aurora_tpu")) \
        == checkout(ref)


def test_no_port_module_names_the_jax_package():
    """The dotted task strings resolve through importlib at run time, so
    no string of the port may name the JAX package."""
    for p in (REPO / "aurora_tpu_torch").rglob("*.py"):
        text = p.read_text().replace("aurora_tpu_torch", "")
        assert "aurora_tpu." not in text, p


def _as_reference(x):
    if isinstance(x, str):
        return x.replace("aurora_tpu_torch.", "aurora_tpu.")
    if isinstance(x, dict):
        return {k: _as_reference(v) for k, v in x.items()}
    return x


def test_registered_tasks_equal_the_reference():
    assert sorted(PORT_BUILTIN) == sorted(JAX_BUILTIN)
    assert {f"vdc_{s}_test" for s in ("camera", "short", "background",
                                      "main_object", "detailed")} \
        <= set(PORT_BUILTIN)
    for name, cfg in PORT_BUILTIN.items():
        want = JAX_BUILTIN[name]
        for field in cfg.__dataclass_fields__:
            assert _as_reference(getattr(cfg, field)) \
                == getattr(want, field), (name, field)
    from aurora_tpu.eval.tasks import TASK_CATALOG as JCAT
    from aurora_tpu_torch.eval.tasks import TASK_CATALOG
    assert TASK_CATALOG == JCAT


def test_vdc_prompt_pools_equal_the_reference():
    from aurora_tpu.eval.tasks import vdc_prompts as jp
    from aurora_tpu_torch.eval.tasks import vdc_prompts as tp
    assert tp.POOLS == jp.POOLS and len(tp.POOLS) == 5
    for name in tp.POOLS:
        assert all(isinstance(p, str) for p in tp.POOLS[name])


@pytest.mark.parametrize("subset", ["camera", "short", "background",
                                    "main_object", "detailed"])
def test_vdc_hooks_equal_the_reference(tmp_path, subset):
    name = f"vdc_{subset}_test"
    jt, tt = japi.Task(JAX_BUILTIN[name]), tapi.Task(PORT_BUILTIN[name])
    docs = []
    for i in range(12):
        np.save(tmp_path / f"v{i}.npy", np.zeros((2, 4, 4, 3), np.uint8))
        docs.append({"video_name": f"v{i}", "caption": f"cap {i}",
                     "qa_list": [{"question": "q", "answer": "a"}],
                     "_root": str(tmp_path)})
    preds = [f"a prediction {i}" for i in range(len(docs))]
    for d, p in zip(docs, preds):
        assert tt.doc_to_text(d) == jt.doc_to_text(d)
        assert tt.doc_to_visual(d) == jt.doc_to_visual(d)
        assert tt.doc_to_target(d) == jt.doc_to_target(d)
        assert tt.process_results(d, [p]) == jt.process_results(d, [p])
    per_doc = [tt.process_results(d, [p])["pred"] for d, p in
               zip(docs, preds)]
    assert tt.aggregate("pred", per_doc) == jt.aggregate("pred", per_doc)


# ---------------------------------------------------------------------------
# AuroraCapEval: the port against the JAX adapter
# ---------------------------------------------------------------------------

N_FRAMES = 8      # the HTTP server's /generate reads 8 frames by default


def _write_docs(base, name, shape, n):
    rng = np.random.default_rng(11)
    docs = []
    for i in range(n):
        np.save(base / f"{name}{i}.npy",
                rng.integers(0, 256, shape).astype(np.uint8))
        docs.append({"video_name": f"{name}{i}", "caption": f"gt {i}",
                     "qa_list": [{"question": "q", "answer": "a"}],
                     "_root": str(base)})
    with open(base / f"{name}.jsonl", "w") as f:
        for d in docs:
            f.write(json.dumps(d) + "\n")
    return str(base / f"{name}.jsonl")


def _register(name, path, max_new=6):
    """The same VDC-shaped task in both registries."""
    for api, pkg in ((japi, "aurora_tpu"), (tapi, "aurora_tpu_torch")):
        m = f"{pkg}.eval.tasks.vdc:"
        api.register_task(api.TaskConfig(
            name=name, dataset_path=path,
            doc_to_visual=m + "doc_to_visual",
            doc_to_text=m + "doc_to_text_detailed",
            doc_to_target=m + "doc_to_target",
            process_results=m + "process_results_generation_only",
            generation_kwargs={"max_new_tokens": max_new,
                               "temperature": 0.0}))


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    from aurora_tpu.eval.models import AuroraCapEval as JAuroraCapEval
    from aurora_tpu_torch.eval.models import AuroraCapEval
    base = tmp_path_factory.mktemp("torch_eval")
    root, *_ = make_tiny_xtuner_dir(base / "model")
    kw = dict(token_merge_ratio=0.5, num_frames=N_FRAMES, image_size=56,
              max_new_tokens=6)
    jev = JAuroraCapEval(pretrained=root, dtype=jnp.float32, **kw)
    tev = AuroraCapEval(pretrained=root, dtype=torch.float32, device="cpu",
                        **kw)
    _register("parity_vdc", _write_docs(base, "v", (N_FRAMES, 56, 56, 3),
                                        3))
    _register("parity_vdc_resized",
              _write_docs(base, "r", (N_FRAMES, 64, 80, 3), 2))
    return base, root, jev, tev


def _recorded_engine_requests(monkeypatch):
    """Each engine's requests as generate_batch adds them, with their
    logprobs asked for (sampling is unchanged by it)."""
    from aurora_tpu.serve.engine import ServeEngine as JServeEngine
    from aurora_tpu_torch.serve.engine import ServeEngine
    seen = {"jax": {}, "port": {}}
    for side, cls in (("jax", JServeEngine), ("port", ServeEngine)):
        add = cls.add_request

        def record(self, req, _add=add, _side=side):
            req.logprobs = True
            seen[_side][req.rid] = req
            return _add(self, req)
        monkeypatch.setattr(cls, "add_request", record)
    return seen


@pytest.mark.parametrize("task", ["parity_vdc", "parity_vdc_resized"])
def test_generate_batch_matches_jax(evals, monkeypatch, task):
    _, _, jev, tev = evals
    seen = _recorded_engine_requests(monkeypatch)
    jt, tt = japi.get_task(task), tapi.get_task(task)
    want = jev.generate_batch(jt.docs(), jt)
    got = tev.generate_batch(tt.docs(), tt)
    assert len(seen["port"]) == len(got) == len(want)
    flips = assert_near_tie_parity(seen["port"], seen["jax"])
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, str)
        if flips[f"doc{i}"][2] is None:       # no flip: the same text
            assert g == w, i


def _recorded_generate(monkeypatch):
    """The dense decode's results (tokens, lengths, chosen-token
    logprobs) of caption() and the text-only path, on both sides."""
    import aurora_tpu.cli.infer as jinfer
    import aurora_tpu.generate as jgen
    import aurora_tpu_torch.cli.infer as tinfer
    import aurora_tpu_torch.generate.engine as tgen
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jinfer), ("jax", jgen), ("port", tinfer),
                      ("port", tgen)):
        fn = mod.generate

        def record(*a, _fn=fn, _side=side, **k):
            k["return_logprobs"] = True
            res = _fn(*a, **k)
            seen[_side].append(res)
            return res
        monkeypatch.setattr(mod, "generate", record)
    return seen


def _assert_dense_near_tie(got, want):
    """One greedy row each: chosen-token logprobs within NEAR_TIE / 2 up
    to the first differing token, where the two sides' chosen tokens must
    be a near tie (their logprobs within NEAR_TIE)."""
    n, m = int(np.asarray(want.lengths)[0]), int(got.lengths[0])
    gt, wt = got.tokens[0].tolist(), np.asarray(want.tokens)[0].tolist()
    glp, wlp = got.logprobs[0].tolist(), np.asarray(want.logprobs)[0]
    for j in range(min(n, m)):
        if gt[j] != wt[j]:
            assert abs(glp[j] - wlp[j]) < NEAR_TIE, (j, glp[j], wlp[j])
            return
        assert abs(glp[j] - wlp[j]) <= NEAR_TIE / 2, (j, glp[j], wlp[j])
    assert m == n


def test_generate_until_matches_jax(evals, monkeypatch):
    base, _, jev, tev = evals
    seen = _recorded_generate(monkeypatch)
    jt, tt = japi.get_task("parity_vdc"), tapi.get_task("parity_vdc")
    doc = tt.docs()[0]
    want, got = jev.generate_until(doc, jt), tev.generate_until(doc, tt)
    # a text-only doc (gsm8k shape, with a stop string)
    gsm = base / "gsm.jsonl"
    gsm.write_text(json.dumps({"question": "2+2?",
                               "answer": "2 and 2\n#### 4"}) + "\n")
    from aurora_tpu.eval.tasks.gsm8k import register_gsm8k as jreg
    from aurora_tpu_torch.eval.tasks.gsm8k import register_gsm8k
    jreg(str(gsm), name="parity_gsm")
    register_gsm8k(str(gsm), name="parity_gsm")
    jg, tg = japi.get_task("parity_gsm"), tapi.get_task("parity_gsm")
    jg.cfg.generation_kwargs["max_new_tokens"] = 6
    tg.cfg.generation_kwargs["max_new_tokens"] = 6
    gdoc = tg.docs()[0]
    want_t, got_t = jev.generate_until(gdoc, jg), tev.generate_until(gdoc, tg)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for g, w in zip(seen["port"], seen["jax"]):
        _assert_dense_near_tie(g, w)
    for g, w, res in ((got, want, 0), (got_t, want_t, 1)):
        assert isinstance(g, str)
        if seen["port"][res].tokens.tolist() == \
                np.asarray(seen["jax"][res].tokens).tolist():
            assert g == w


def test_loglikelihood_choices_match_jax(evals):
    base, _, jev, tev = evals
    rng = np.random.default_rng(3)
    np.save(base / "img0.npy",
            rng.integers(0, 255, (1, 56, 56, 3)).astype(np.uint8))
    with open(base / "mc.jsonl", "w") as f:
        f.write(json.dumps({"image": "img0.npy", "_root": str(base),
                            "question": "what?", "options": ["cat", "dog"],
                            "answer": 0}) + "\n")
    with open(base / "mmlu.jsonl", "w") as f:
        f.write(json.dumps({"question": "2+2?", "choices": ["3", "4"],
                            "answer": 1, "subject": "math"}) + "\n")
    from aurora_tpu.eval.tasks import image_mc as jmc
    from aurora_tpu.eval.tasks import text_mc as jtm
    from aurora_tpu_torch.eval.tasks import image_mc, text_mc
    jmc.register_image_mc("parity_mc", str(base / "mc.jsonl"))
    image_mc.register_image_mc("parity_mc", str(base / "mc.jsonl"))
    jtm.register_mmlu(str(base / "mmlu.jsonl"), name="parity_mmlu")
    text_mc.register_mmlu(str(base / "mmlu.jsonl"), name="parity_mmlu")
    for name in ("parity_mc_ppl", "parity_mmlu"):
        jt, tt = japi.get_task(name), tapi.get_task(name)
        assert tt.cfg.output_type == "loglikelihood"
        want = jev.loglikelihood_choices(jt.docs()[0], jt)
        got = tev.loglikelihood_choices(tt.docs()[0], tt)
        assert len(got) == len(want) >= 2
        np.testing.assert_allclose(got, want, rtol=0, atol=LL_TOL)


def test_http_model_eval_on_the_port_server(evals):
    """HTTPModelEval posts each video doc's path to the port's /generate
    (read, resized and encoded by the server) and a text-only doc to its
    chat route; the video answers equal generate_batch's on the same
    model, and the text answer the server's own chat answer."""
    from aurora_tpu_torch.eval.models import HTTPModelEval
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import AuroraCapServing
    from aurora_tpu_torch.utils.http import chat_completion
    _, _, _, tev = evals
    task = tapi.get_task("parity_vdc")
    docs = task.docs()
    want = tev.generate_batch(docs, task)
    mm = AuroraCapServing(tev.model, tev.tokenizer,
                          kept_ratio=tev.token_merge_ratio, image_size=56)
    engine = ServeEngine(tev.model.llm, tev.cfg.llm, EngineConfig(
        max_batch=2, max_seq_len=512, prefill_buckets=(256,),
        kv_dtype=torch.float32, kv_chunk=64), embed_fn=mm.embed_fn,
        tokenizer=tev.tokenizer)
    with ServerThread(ServingLoop(engine, tev.tokenizer, mm)) as srv:
        http = HTTPModelEval(srv.url, max_new_tokens=6)
        got = [http.generate_until(d, task) for d in docs]
        gsm = japi.TaskConfig(name="x", generation_kwargs={
            "max_new_tokens": 5})

        class TextTask:
            cfg, doc_to_visual = gsm, None

            @staticmethod
            def doc_to_text(doc):
                return doc["q"]
        text = http.generate_until({"q": "hello"}, TextTask)
        direct = chat_completion(srv.url, [{"role": "user",
                                            "content": "hello"}],
                                 max_tokens=5, temperature=0.0)
    assert got == want
    assert isinstance(text, str) and text == direct


# ---------------------------------------------------------------------------
# The CLI modes
# ---------------------------------------------------------------------------

def test_no_ported_mode_exits_2(capsys):
    from aurora_tpu_torch import __main__ as entry
    for mode in ("test", "eval", "post-eval", "mmbench"):
        assert mode in entry._PORTED and mode not in entry._NOT_PORTED
    for mode in entry._PORTED:
        with pytest.raises(SystemExit) as e:
            entry.main([mode, "--help"])
        assert e.value.code == 0, mode
        assert "usage" in capsys.readouterr().out, mode


def test_eval_list_tasks_lists_the_zoo():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "aurora_tpu_torch", "eval",
                          "--tasks", "x", "--list_tasks"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert set(res.stdout.split()) >= set(PORT_BUILTIN)


def test_eval_and_post_eval_modes_run(evals, fake_judge, tmp_path, capsys):
    from aurora_tpu_torch import __main__ as entry
    _, root, _, _ = evals
    out = tmp_path / "out"
    for mode in ("eval", "test"):
        assert entry.main([
            mode, "--model_args",
            f"pretrained={root},image_size=56,num_frames=2,device=cpu,"
            "dtype=float32", "--tasks", "parity_vdc", "--limit", "1",
            "--output_path", str(out / mode), "--log_samples"]) == 0
        results = json.loads((out / mode / "results.json").read_text())
        assert results["parity_vdc"]["_n"] == 1
    capsys.readouterr()
    sample = json.loads((out / "eval" / "parity_vdc_samples.jsonl")
                        .read_text().splitlines()[0])
    caps = tmp_path / "caps.jsonl"
    caps.write_text(json.dumps({"video_name": "v0",
                                "pred": sample["pred"]}) + "\n")
    gt = tmp_path / "gt.jsonl"
    gt.write_text(json.dumps({"video_name": "v0", "qa_list": [
        {"question": "q1", "answer": "a1"},
        {"question": "q2", "answer": "a2"}]}) + "\n")
    assert entry.main(["post-eval", "--captions", str(caps), "--gt",
                       str(gt), "--judge-url", fake_judge.url, "--out",
                       str(tmp_path / "scores.json")]) == 0
    scores = json.loads((tmp_path / "scores.json").read_text())
    assert scores["n"] == 1 and 0 <= scores["score"] <= 5


def test_mmbench_mode_runs(evals, tmp_path, capsys):
    import base64
    import csv
    import io
    from PIL import Image
    from aurora_tpu_torch import __main__ as entry
    _, root, _, _ = evals
    rng = np.random.default_rng(2)
    rows = []
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (56, 56, 3)).astype(
            np.uint8)).save(buf, format="PNG")
        rows.append({"index": i, "image": base64.b64encode(
            buf.getvalue()).decode(), "question": "what is this?",
            "hint": "", "A": "a", "B": "b", "C": "c", "D": "d",
            "answer": "A"})
    tsv = tmp_path / "mm.tsv"
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    assert entry.main(["mmbench", "--model_path", root, "--data-path",
                       str(tsv), "--work-dir", str(tmp_path / "w"),
                       "--image-size", "56", "--max-new-tokens", "2",
                       "--dtype", "float32", "--device", "cpu"]) == 0
    out = json.loads((tmp_path / "w" / "mmbench_results.json").read_text())
    assert out["n"] == 2 and out["accuracy"] is not None
