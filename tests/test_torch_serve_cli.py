"""The port's serving CLIs (`python -m aurora_tpu_torch serve | chat |
bench-latency | bench-serving`) on the CPU.

Each mode's --help exits 0; serve takes --dp / --tp above 1 (they reach
the server with their engine built), exits 2 for what stays single-device at --tp above
1 (W4 weights, packed int4 KV, a Mixtral checkpoint at W4) and for what
MLA does not take (DeepseekV2 with --kv-quant or --tp), and loads MoE and
MLA directories (Gemma-2 is served:
tests/test_torch_gemma2.py); chat over stdin on a tiny xtuner directory and a
video prints the JAX cli/chat.py's two answers, fp32 and greedy, text for
text, and encodes the video once for both turns (a video that needs a
resize too); bench-latency on the tiny
preset prints its JSON keys; bench-serving against the port's server
counts every request ok.
"""

import io
import json
import sys

import numpy as np
import pytest
import torch

from aurora_tpu_torch import __main__ as entry
from aurora_tpu_torch.cli import chat as tchat
from aurora_tpu_torch.cli import serve as tserve

from utils import make_tiny_tokenizer, make_tiny_xtuner_dir

TURNS = "hello there\nand then?\n"


@pytest.mark.parametrize("mode,flags", [
    ("serve", ("--model_path", "--aurora", "--num-slots", "--device")),
    ("chat", ("--visual_input",)), ("bench-latency", ("--preset",)),
    ("bench-serving", ("--concurrency",))])
def test_mode_help_exits_0(capsys, mode, flags):
    """`python -m aurora_tpu_torch MODE --help` (the `main` that `-m`
    runs; tests/test_torch_infer.py runs `-m` itself) exits 0."""
    with pytest.raises(SystemExit) as e:
        entry.main([mode, "--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and all(f in out for f in flags)


@pytest.mark.parametrize("case", ["dp", "tp", "MixtralForCausalLM",
                                  "DeepseekV2ForCausalLM"])
def test_serve_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch,
                                          case):
    """--dp and --tp are ported: each reaches the server with its engine
    built (two replicas, or one engine of two shards; under --tp the
    model loaded on the host is no longer referenced once the engine is
    built), and with --tp 2 the W4 layout exits 2 (the reference's
    assert); a Mixtral checkpoint at W4 with --tp 2 exits 2 the same way,
    DeepseekV2 with --kv-quant or --tp exits 2 naming MLA."""
    import gc
    import weakref
    from aurora_tpu_torch.data import text
    from aurora_tpu_torch.serve import api
    argv = ["--model_path", str(tmp_path)]
    if case in ("dp", "tp"):
        from aurora_tpu_torch.models import export
        from aurora_tpu_torch.models.init import build
        from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
        cfg = LlamaConfig.tiny(vocab_size=128)
        model = build(LlamaModel, cfg, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
        export._write(export.llama_state_dict(model, cfg),
                      export.llama_config_dict(cfg), str(tmp_path))
        from aurora_tpu_torch.models import convert
        loaded, launched = [], {}
        load_dir = convert.load_serving_dir

        def load(*a):
            model, cfg = load_dir(*a)
            loaded.append(weakref.ref(model))
            return model, cfg

        def serve(engine, tok, **kw):
            gc.collect()
            launched.update(engine=engine, source_alive=loaded[-1]() is not
                            None)
        monkeypatch.setattr(convert, "load_serving_dir", load)
        monkeypatch.setattr(api, "serve_engine", serve)
        monkeypatch.setattr(text, "auto_tokenizer", lambda path: object())
        common = ["--device", "cpu", "--dtype", "float32", "--max-batch",
                  "2", "--num-slots", "64", f"--{case}", "2"]
        assert tserve.main(argv + common) == 0
        engine = launched["engine"]
        if case == "dp":
            assert len(engine.engines) == 2
        else:
            assert engine.ecfg.tp == 2 and len(engine.runner.group.models) == 2
            assert not launched["source_alive"]
        assert tserve.main(argv + common + ["--tp", "2", "--weight-quant",
                                            "int4"]) == 2
        assert "single-device" in capsys.readouterr().err
        return
    # MoE and MLA checkpoints are served (test_serve_loads_moe_and_mla_
    # dirs); a Mixtral one takes no W4 at tp 2, and MLA no KV quantization
    # or tp, as in the reference
    (tmp_path / "config.json").write_text(json.dumps(
        {"architectures": [case], "model_type": case[:-11].lower()}))
    if case.startswith("Mixtral"):
        argv += ["--tp", "2", "--weight-quant", "int4"]
        item = "single-device"
    else:
        argv += ["--kv-quant", "int8"]
        item = "MLA"
    assert tserve.main(argv) == 2
    assert item in capsys.readouterr().err
    if not case.startswith("Mixtral"):
        assert tserve.main(argv[:2] + ["--tp", "2"]) == 2
        assert "MLA" in capsys.readouterr().err


def test_serve_loads_moe_and_mla_dirs(tmp_path, monkeypatch):
    """A Mixtral directory with --weight-quant int8 (each layer quantized
    as it loads: int8 experts, W8 attention, fused streams) and a
    DeepseekV2 one (bf16-only MLA, here fp32 on the CPU) reach the HTTP
    server with an engine built on their serving config."""
    from safetensors.numpy import save_file

    import test_torch_mla as mla
    import test_torch_moe as moe
    from aurora_tpu_torch.data import text
    from aurora_tpu_torch.serve import api

    launched = {}
    monkeypatch.setattr(api, "serve_engine",
                        lambda engine, tok, **kw: launched.update(
                            model=engine.runner.model, cfg=engine.cfg))
    monkeypatch.setattr(text, "auto_tokenizer", lambda path: object())
    hf_cfg, sd = moe._mixtral(np.random.default_rng(0))
    mix = tmp_path / "mixtral"
    mix.mkdir()
    save_file(moe._scaled(sd), str(mix / "model.safetensors"))
    (mix / "config.json").write_text(json.dumps(
        dict(hf_cfg, architectures=["MixtralForCausalLM"])))
    common = ["--device", "cpu", "--dtype", "float32", "--max-batch", "2",
              "--num-slots", "64"]
    assert tserve.main(["--model_path", str(mix), "--weight-quant", "int8",
                        *common]) == 0
    last = launched["model"].layers[-1]
    assert launched["cfg"].num_experts == moe.E
    assert last.moe_gate.weight.dtype == torch.int8 and hasattr(last, "qkv")
    _, tree, tcfg, _ = mla.pair("lite")
    mla._write_dir(str(tmp_path / "ds"), tree,
                   dict(mla.HF_BASE, max_position_embeddings=256))
    assert tserve.main(["--model_path", str(tmp_path / "ds"), *common]) == 0
    assert launched["cfg"].mla_kv_lora_rank == tcfg.kv_lora_rank


def _chat_lines(out):
    return [ln for ln in out.splitlines() if "ASSISTANT:" in ln]


@pytest.fixture(scope="module")
def xtuner_dir(tmp_path_factory):
    return make_tiny_xtuner_dir(tmp_path_factory.mktemp("m"))[0]


def test_chat_matches_jax(xtuner_dir, tmp_path, monkeypatch, capsys):
    """Two turns over stdin about a video whose frames are already at the
    tower's 56 pixels (so that PIL's resize on the JAX side and the
    device resize here both leave them as they are; the JAX chat needs a
    visual input): the port's answers are the JAX chat's."""
    from aurora_tpu.cli import chat as jchat
    root = xtuner_dir
    video = str(tmp_path / "v.npy")
    np.save(video, np.random.default_rng(1).integers(
        0, 256, size=(2, 56, 56, 3), dtype=np.uint8))
    flags = ["--model_path", root, "--visual_input", video, "--num_frm",
             "2", "--image_size", "56", "--token_kept_ratio", "0.5",
             "--dtype", "float32", "--max_new_tokens", "6"]
    monkeypatch.setattr(sys, "argv", ["chat", *flags])
    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    jchat.main()
    want = _chat_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    assert entry.main(["chat", *flags, "--device", "cpu"]) == 0
    got = _chat_lines(capsys.readouterr().out)
    assert len(want) == 2 and got == want


def test_chat_encodes_the_video_once(xtuner_dir, tmp_path, monkeypatch,
                                     capsys):
    """With a video, both turns splice the visual tokens of one encode."""
    root = xtuner_dir
    video = str(tmp_path / "v.npy")
    np.save(video, np.random.default_rng(0).integers(
        0, 256, size=(4, 60, 70, 3), dtype=np.uint8))
    calls = []
    real = tchat.encode_visual

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(tchat, "encode_visual", counted)
    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    tchat.main(["--model_path", root, "--visual_input", video,
                "--num_frm", "2", "--image_size", "56",
                "--token_kept_ratio", "0.5", "--dtype", "float32",
                "--max_new_tokens", "4", "--device", "cpu"])
    assert len(_chat_lines(capsys.readouterr().out)) == 2
    assert calls == [(1, 2, 3, 56, 56)]


def test_bench_latency_prints_its_json(monkeypatch, capsys):
    monkeypatch.setenv("AURORA_NATIVE_RADIX", "0")    # no g++ build here
    entry.main(["bench-latency", "--preset", "tiny", "--device", "cpu",
                "--dtype", "float32", "--batch", "2", "--prompt-len", "16",
                "--decode-steps", "3", "--max-seq-len", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"preset", "batch", "prompt_len", "prefill_s",
            "prefill_tokens_per_s", "decode_steps", "decode_tokens_per_s",
            "backend", "device"} <= set(out)
    assert (out["backend"], out["device"], out["batch"]) == ("cpu", "cpu", 2)
    assert out["prefill_s"] > 0 and out["decode_tokens_per_s"] > 0


def test_bench_serving_against_the_port_server(tmp_path, monkeypatch,
                                               capsys):
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine

    monkeypatch.setenv("AURORA_NATIVE_RADIX", "0")
    tok = make_tiny_tokenizer(str(tmp_path / "tok"))
    cfg = LlamaConfig.tiny(vocab_size=512)
    model = build(LlamaModel, cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    engine = ServeEngine(model, cfg, EngineConfig(
        max_batch=2, max_seq_len=64, num_slots=256, prefill_buckets=(32,),
        kv_dtype=torch.float32, kv_chunk=32), tokenizer=tok)
    with ServerThread(ServingLoop(engine, tok)) as srv:
        entry.main(["bench-serving", "--url", srv.url, "--num-requests",
                    "5", "--concurrency", "2", "--prompt-len", "12",
                    "--max-tokens", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] == out["num_requests"] == 5
    assert out["output_tokens_per_s"] > 0
    assert set(out["latency_s"]) == {"p50", "p90", "p99"}
