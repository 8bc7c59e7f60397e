"""Config and dataset inspection tools, the `xtuner list-cfg / copy-cfg /
log-dataset / check-custom-dataset` equivalents (aurora_tpu/cli/cfg_tools.py).

  * list-cfg   enumerates the stage configs, model presets, prompt
               templates and registered eval tasks;
  * copy-cfg   writes a stage config as editable JSON; the train CLI
               loads it back with `--config FILE` (field-level overrides,
               the `--cfg-options` analog);
  * log-dataset renders the first N processed samples as the trainer
               sees them (token ids, label mask, decoded text); the
               tokenizer comes through transformers' AutoTokenizer
               (data/text.py auto_tokenizer), the frames on --device;
  * check-custom-dataset validates llava-format records structurally
               (keys, role alternation, <image>/<video> placeholders).
The model presets are the reference's, in its order.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List


# ---------------------------------------------------------------------------
# list-cfg / copy-cfg
# ---------------------------------------------------------------------------

def _stage_configs():
    from aurora_tpu_torch.train.configs import STAGES
    return dict(STAGES)


def _model_presets():
    from aurora_tpu_torch.models.aurora import AuroraConfig
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.models.vit import ViTConfig
    return {
        "auroracap_7b": AuroraConfig.auroracap_7b,
        "auroracap_tiny": AuroraConfig.tiny,
        "vicuna_7b_v15_16k": LlamaConfig.vicuna_7b_v15_16k,
        "qwen2_7b": LlamaConfig.qwen2_7b,
        "mistral_7b": LlamaConfig.mistral_7b,
        "llama_tiny": LlamaConfig.tiny,
        "dfn5b_vit_h_378": ViTConfig.dfn5b_vit_h_378,
    }


def list_cfg(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="aurora list-cfg",
                                description="List predefined configs")
    p.add_argument("-p", "--pattern", default=None,
                   help="substring filter (list_cfg.py --pattern parity)")
    args = p.parse_args(argv)

    from aurora_tpu_torch.eval import api as eval_api
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE
    import aurora_tpu_torch.eval.tasks  # noqa: F401 — populate the registry

    from aurora_tpu_torch.eval.tasks import catalog_status
    catalog = [
        f"{n}  [{'ready' if ok else f'needs data: ${env} or {path}'}]"
        for n, env, path, ok in catalog_status()]
    sections = {
        "stage configs (train --stage / copy-cfg)":
            sorted(_stage_configs()),
        "model presets": sorted(_model_presets()),
        "prompt templates (data --template)":
            sorted(vars(PROMPT_TEMPLATE)),
        "eval tasks registered (python -m aurora_tpu_torch.eval --tasks)":
            eval_api.list_tasks(),
        "eval task catalog (auto-registers when data exists)": catalog,
    }
    for title, names in sections.items():
        if args.pattern:
            names = [n for n in names if args.pattern in n]
        if not names:
            continue
        print(f"=== {title} ===")
        for n in names:
            print(f"  {n}")
    return 0


def copy_cfg(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="aurora copy-cfg",
                                description="Copy a stage config to an "
                                            "editable JSON file")
    p.add_argument("name", help="stage config name (see list-cfg)")
    p.add_argument("save_path", help="output .json path")
    args = p.parse_args(argv)

    stages = _stage_configs()
    if args.name not in stages:
        print(f"unknown config {args.name!r}; known: {sorted(stages)}",
              file=sys.stderr)
        return 1
    cfg = stages[args.name]()
    out = dataclasses.asdict(cfg)
    out["_stage"] = args.name     # round-trip marker for train --config
    path = args.save_path
    if not path.endswith(".json"):
        path += ".json"
    with open(path, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"copied {args.name} -> {path}")
    return 0


def load_cfg_overrides(path: str, stage):
    """Apply a copy-cfg JSON back onto a StageConfig (train --config)."""
    import dataclasses as dc
    with open(path) as f:
        raw = json.load(f)
    raw.pop("_stage", None)
    train_raw = raw.pop("train", {})
    tfields = {f.name for f in dc.fields(stage.train)}
    train = dc.replace(stage.train,
                       **{k: v for k, v in train_raw.items()
                          if k in tfields})
    sfields = {f.name for f in dc.fields(stage)}
    return dc.replace(stage, train=train,
                      **{k: v for k, v in raw.items() if k in sfields})


# ---------------------------------------------------------------------------
# check-custom-dataset
# ---------------------------------------------------------------------------

def check_records(records: List[dict]) -> List[str]:
    """Structural validation of llava-format records. Returns issues
    ('idx: message'); empty list = clean."""
    issues = []
    for i, rec in enumerate(records):
        convs = rec.get("conversations")
        if not isinstance(convs, list) or not convs:
            issues.append(f"{i}: missing/empty 'conversations'")
            continue
        mm_keys = [k for k in ("image", "video") if rec.get(k)]
        has_placeholder = any(
            "<image>" in str(t.get("value", "")) or
            "<video>" in str(t.get("value", "")) for t in convs)
        if mm_keys and not has_placeholder:
            issues.append(f"{i}: has {mm_keys[0]!r} but no <image>/"
                          "<video> placeholder in any turn")
        if not mm_keys and has_placeholder:
            issues.append(f"{i}: has a multimodal placeholder but no "
                          "'image'/'video' key")
        for j, turn in enumerate(convs):
            frm = turn.get("from")
            want = "human" if j % 2 == 0 else "gpt"
            if frm != want:
                issues.append(f"{i}: turn {j} is from {frm!r}, expected "
                              f"{want!r} (human/gpt must alternate)")
                break
            if not isinstance(turn.get("value"), str):
                issues.append(f"{i}: turn {j} 'value' is not a string")
                break
        ph_turns = [j for j, t in enumerate(convs)
                    if "<image>" in str(t.get("value", ""))
                    or "<video>" in str(t.get("value", ""))]
        if ph_turns and ph_turns != [0]:
            issues.append(f"{i}: multimodal placeholder must appear in "
                          f"turn 0 only (found in turns {ph_turns})")
    return issues


def check_custom_dataset(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="aurora check-custom-dataset")
    p.add_argument("--data", required=True, help="llava-format json/jsonl")
    p.add_argument("--max-errors", type=int, default=20)
    args = p.parse_args(argv)

    from aurora_tpu_torch.data.dataset import read_json_or_jsonl
    records = read_json_or_jsonl(args.data)
    issues = check_records(records)
    for msg in issues[:args.max_errors]:
        print(f"  [issue] {msg}")
    n_img = sum(1 for r in records if r.get("image"))
    n_vid = sum(1 for r in records if r.get("video"))
    print(f"{len(records)} records ({n_img} image, {n_vid} video, "
          f"{len(records) - n_img - n_vid} text-only); "
          f"{len(issues)} issue(s)")
    return 1 if issues else 0


# ---------------------------------------------------------------------------
# log-dataset
# ---------------------------------------------------------------------------

def log_dataset(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="aurora log-dataset",
                                description="Render the first N processed "
                                            "samples as the trainer sees "
                                            "them")
    p.add_argument("--data", required=True)
    p.add_argument("--model_path", required=True,
                   help="tokenizer source (xtuner/HF dir)")
    p.add_argument("--image_folder", default="")
    p.add_argument("--template", default="vicuna")
    p.add_argument("--max_length", type=int, default=4096)
    p.add_argument("-n", "--num", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from aurora_tpu_torch.data.dataset import AuroraDataset, aurora_map_fn
    from aurora_tpu_torch.data.text import auto_tokenizer
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

    tokenizer = auto_tokenizer(args.model_path, padding_side="right")
    ds = AuroraDataset(args.data, tokenizer,
                       image_folder=args.image_folder,
                       map_fn=aurora_map_fn,
                       template=getattr(PROMPT_TEMPLATE, args.template),
                       max_length=args.max_length, device=args.device)
    for i in range(min(args.num, len(ds))):
        s = ds[i]
        ids = list(s["input_ids"])
        labels = list(s["labels"])
        print(f"#### sample {i} " + "#" * 50)
        print(f"len={len(ids)} supervised={sum(l >= 0 for l in labels)} "
              f"pixels={'yes' if s.get('pixel_values') is not None else 'no'}")
        print("--- decoded input ---")
        print(tokenizer.decode([t for t in ids if t >= 0]))
        print("--- decoded supervised span(s) ---")
        print(tokenizer.decode([t for t, l in zip(ids, labels) if l >= 0]))
    return 0
