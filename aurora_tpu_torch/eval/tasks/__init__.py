"""Built-in task definitions. Importing this package registers them."""

from aurora_tpu_torch.eval.tasks import (captions, gsm8k,  # noqa: F401
                                   ifeval, image_judge, image_mc,
                                   mmbench, refcoco, text_mc, vdc,
                                   video_mc, videochatgpt, videoqa,
                                   vqa, yesno)

# Catalog of every built-in task: name → (env var that points at the
# local dataset, default path). Tasks auto-register at import when their
# dataset exists; `catalog_status()` (and `aurora list-cfg`) shows the
# full zoo either way. "+ppl" names also register a `<name>_ppl`
# loglikelihood variant.
TASK_CATALOG = {
    # always registered (prompt pools ship in-repo)
    "vdc_{camera,short,background,main_object,detailed}_test":
        ("AURORA_VDC_DIR", "data/vdc"),
    # image understanding
    "mmbench_dev": ("AURORA_MMBENCH_TSV", "data/mmbench/dev.tsv"),
    "ai2d (+ppl)": ("AURORA_AI2D", "data/ai2d/test.jsonl"),
    "scienceqa_img (+ppl)": ("AURORA_SCIENCEQA",
                             "data/scienceqa/test.jsonl"),
    "seedbench (+ppl)": ("AURORA_SEEDBENCH", "data/seedbench/test.jsonl"),
    "mmstar (+ppl)": ("AURORA_MMSTAR", "data/mmstar/val.jsonl"),
    "realworldqa (+ppl)": ("AURORA_REALWORLDQA",
                           "data/realworldqa/test.jsonl"),
    "mmmu_val (+ppl)": ("AURORA_MMMU", "data/mmmu/val.jsonl"),
    "cvbench (+ppl)": ("AURORA_CVBENCH", "data/cvbench/test.jsonl"),
    "blink (+ppl)": ("AURORA_BLINK", "data/blink/val.jsonl"),
    "mmt_bench (+ppl)": ("AURORA_MMT", "data/mmt_bench/val.jsonl"),
    "seedbench2 (+ppl)": ("AURORA_SEEDBENCH2",
                          "data/seedbench2/test.jsonl"),
    "vstar_bench (+ppl)": ("AURORA_VSTAR",
                           "data/vstar_bench/test.jsonl"),
    "mathvista_testmini": ("AURORA_MATHVISTA",
                           "data/mathvista/testmini.jsonl"),
    "mmvet": ("AURORA_MMVET", "data/mmvet/test.jsonl"),
    "llava_in_the_wild": ("AURORA_LLAVA_WILD",
                          "data/llava_in_the_wild/test.jsonl"),
    "pope": ("AURORA_POPE", "data/pope/test.jsonl"),
    "mme": ("AURORA_MME", "data/mme/test.jsonl"),
    "hallusion_bench": ("AURORA_HALLUSION",
                        "data/hallusion_bench/test.jsonl"),
    "refcoco": ("AURORA_REFCOCO", "data/refcoco/val.jsonl"),
    # open-ended VQA
    "vqav2": ("AURORA_VQAV2", "data/vqav2/val.jsonl"),
    "gqa": ("AURORA_GQA", "data/gqa/val.jsonl"),
    "textvqa": ("AURORA_TEXTVQA", "data/textvqa/val.jsonl"),
    "vizwiz_vqa": ("AURORA_VIZWIZ", "data/vizwiz_vqa/val.jsonl"),
    "ok_vqa": ("AURORA_OKVQA", "data/ok_vqa/val.jsonl"),
    "docvqa": ("AURORA_DOCVQA", "data/docvqa/val.jsonl"),
    "infovqa": ("AURORA_INFOVQA", "data/infovqa/val.jsonl"),
    "stvqa": ("AURORA_STVQA", "data/stvqa/val.jsonl"),
    "chartqa": ("AURORA_CHARTQA", "data/chartqa/test.jsonl"),
    "ocrbench": ("AURORA_OCRBENCH", "data/ocrbench/test.jsonl"),
    # captions
    "coco_cap": ("AURORA_COCO_CAP", "data/coco_cap/val.jsonl"),
    "flickr30k": ("AURORA_FLICKR30K", "data/flickr30k/val.jsonl"),
    "nocaps": ("AURORA_NOCAPS", "data/nocaps/val.jsonl"),
    "textcaps": ("AURORA_TEXTCAPS", "data/textcaps/val.jsonl"),
    "youcook2": ("AURORA_YOUCOOK2", "data/youcook2/val.jsonl"),
    "vatex_test": ("AURORA_VATEX", "data/vatex/test.jsonl"),
    # video QA / MC
    "videomme": ("AURORA_VIDEOMME", "data/videomme/test.jsonl"),
    "mvbench": ("AURORA_MVBENCH", "data/mvbench/test.jsonl"),
    "egoschema (+ppl)": ("AURORA_EGOSCHEMA", "data/egoschema/test.jsonl"),
    "nextqa_mc (+ppl)": ("AURORA_NEXTQA", "data/nextqa/mc.jsonl"),
    "perceptiontest (+ppl)": ("AURORA_PERCEPTIONTEST",
                              "data/perceptiontest/val.jsonl"),
    "tempcompass_mc": ("AURORA_TEMPCOMPASS", "data/tempcompass/mc.jsonl"),
    "longvideobench_val": ("AURORA_LONGVIDEOBENCH",
                           "data/longvideobench/val.jsonl"),
    "mlvu": ("AURORA_MLVU", "data/mlvu/test.jsonl"),
    "activitynetqa": ("AURORA_ACTIVITYNETQA",
                      "data/activitynetqa/test.jsonl"),
    "videochatgpt_qa": ("AURORA_VIDEOCHATGPT",
                        "data/videochatgpt_qa/test.jsonl"),
    "videochatgpt_{generic,temporal,consistency}":
        ("AURORA_VIDEOCHATGPT_DIR", "data/videochatgpt"),
    # text-only (engine loglikelihood path)
    "mmlu": ("AURORA_MMLU", "data/mmlu/test.jsonl"),
    "hellaswag": ("AURORA_HELLASWAG", "data/hellaswag/val.jsonl"),
    "arc_challenge": ("AURORA_ARC_CHALLENGE",
                      "data/arc_challenge/test.jsonl"),
    "arc_easy": ("AURORA_ARC_EASY", "data/arc_easy/test.jsonl"),
    "gpqa": ("AURORA_GPQA", "data/gpqa/main.jsonl"),
    "mmlu_pro": ("AURORA_MMLU_PRO", "data/mmlu_pro/test.jsonl"),
    "gsm8k": ("AURORA_GSM8K", "data/gsm8k/test.jsonl"),
    "ifeval": ("AURORA_IFEVAL", "data/ifeval/input_data.jsonl"),
    # image MC (round-3 batch 2)
    "cmmmu (+ppl)": ("AURORA_CMMMU", "data/cmmmu/val.jsonl"),
    "iconqa (+ppl)": ("AURORA_ICONQA", "data/iconqa/test.jsonl"),
    "ii_bench (+ppl)": ("AURORA_IIBENCH", "data/ii_bench/test.jsonl"),
    "mmmu_pro (+ppl)": ("AURORA_MMMU_PRO", "data/mmmu_pro/test.jsonl"),
    "mmupd (+ppl)": ("AURORA_MMUPD", "data/mmupd/test.jsonl"),
    "qbench (+ppl)": ("AURORA_QBENCH", "data/qbench/dev.jsonl"),
    "seedbench2_plus (+ppl)": ("AURORA_SEEDBENCH2PLUS",
                               "data/seedbench2_plus/test.jsonl"),
    "muirbench (+ppl)": ("AURORA_MUIRBENCH",
                         "data/muirbench/test.jsonl"),
    "mirb (+ppl)": ("AURORA_MIRB", "data/mirb/test.jsonl"),
    # judge-scored image sets
    "llava_bench_coco": ("AURORA_LLAVA_BENCH_COCO",
                         "data/llava_bench_coco/test.jsonl"),
    "llava_wilder": ("AURORA_LLAVA_WILDER",
                     "data/llava_wilder/test.jsonl"),
    "wild_vision_bench": ("AURORA_WILD_VISION",
                          "data/wild_vision_bench/test.jsonl"),
    "vibe_eval": ("AURORA_VIBE_EVAL", "data/vibe_eval/test.jsonl"),
    "llava_wild_multilingual": ("AURORA_LLAVA_WILD_ML",
                                "data/llava_wild_multilingual/"
                                "test.jsonl"),
    # open-ended / OCR / web
    "gqa_ru": ("AURORA_GQA_RU", "data/gqa_ru/val.jsonl"),
    "multidocvqa": ("AURORA_MULTIDOCVQA", "data/multidocvqa/val.jsonl"),
    "synthdog": ("AURORA_SYNTHDOG", "data/synthdog/val.jsonl"),
    "websrc": ("AURORA_WEBSRC", "data/websrc/dev.jsonl"),
    "vcr_wiki": ("AURORA_VCR_WIKI", "data/vcr_wiki/test.jsonl"),
    "detailcaps": ("AURORA_DETAILCAPS", "data/detailcaps/test.jsonl"),
    # grounding
    "refcoco_plus": ("AURORA_REFCOCO_PLUS",
                     "data/refcoco_plus/val.jsonl"),
    "refcocog": ("AURORA_REFCOCOG", "data/refcocog/val.jsonl"),
    "screenspot": ("AURORA_SCREENSPOT", "data/screenspot/test.jsonl"),
    # video
    "cvrr": ("AURORA_CVRR", "data/cvrr/test.jsonl"),
    "worldqa": ("AURORA_WORLDQA", "data/worldqa/test.jsonl"),
    "video_detail_description": ("AURORA_VIDEO_DETAIL",
                                 "data/video_detail_description/"
                                 "test.jsonl"),
    "vitatecs": ("AURORA_VITATECS", "data/vitatecs/test.jsonl"),
}


def catalog_status():
    """[(catalog name, env var, default path, registered?)] — registered
    means the dataset was found and the task is runnable right now."""
    from aurora_tpu_torch.eval.api import list_tasks
    live = set(list_tasks())

    def _hit(name):
        base = name.split(" ")[0]
        if "{" in base:
            pre, rest = base.split("{", 1)
            opts = rest.split("}")[0].split(",")
            return any(pre + o + rest.split("}")[1] in live for o in opts)
        # registries may suffix the split/protocol (refcoco → refcoco_val,
        # perceptiontest → perceptiontest_mc): accept the common variants
        # so a ready task never shows as 'needs data' in list-cfg
        return any(base + suf in live
                   for suf in ("", "_val", "_test", "_dev", "_mc"))
    return [(n, env, path, _hit(n))
            for n, (env, path) in TASK_CATALOG.items()]
