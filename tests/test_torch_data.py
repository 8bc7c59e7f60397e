"""The port's training data pipeline against the JAX package's, on the CPU:
samplers, collation and packing (numpy arrays equal exactly), packed
batches through the model (`fuse_multimodal`'s segments exact, the
packed loss within 1e-5 of JAX's and of the same documents unpacked,
fp32), the resumable index stream, the prefetcher, the map fns and tokenization
(`text_data` equal with the tiny tokenizer, the tokenization cache), the
frames (`pixel_values` within 2/255 per channel of PIL's before
normalization, on smooth images, for the plain, pad-to-square and
keep-aspect paths), and the PNG reader (equal to PIL's convert("RGB") bit
for bit for L, LA, RGB, RGBA and P images, and every row filter); a
missing or undecodable file gives a zero frame, a format no decoder on
the host reads raises.
"""

import json
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aurora_tpu.data import collate as jcollate
from aurora_tpu.data import dataset as jdataset
from aurora_tpu.data import prefetch as jprefetch
from aurora_tpu.data import sampler as jsampler
from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.models.projector import init_projector_params
from aurora_tpu.models.vit import init_vit_params
from aurora_tpu.utils.constants import IMAGE_TOKEN_INDEX
from aurora_tpu.utils.templates import PROMPT_TEMPLATE
from aurora_tpu_torch import bridge
from aurora_tpu_torch.data import collate as tcollate
from aurora_tpu_torch.data import dataset as tdataset
from aurora_tpu_torch.data import image as timage
from aurora_tpu_torch.data import prefetch as tprefetch
from aurora_tpu_torch.data import sampler as tsampler
from aurora_tpu_torch.data.preprocess import CLIP_STD
from aurora_tpu_torch.models import aurora as taurora

from utils import make_tiny_tokenizer  # noqa: E402

PIXEL_TOL = 2.0 / 255.0      # per channel, before normalization
STD = np.asarray(CLIP_STD, np.float32)[:, None, None]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    return make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))


def _samples(rng, n=9, frames=True):
    out = []
    for i in range(n):
        L = int(rng.integers(3, 30))
        ids = rng.integers(3, 250, size=L).tolist()
        if frames and i % 3 != 2:
            ids[1] = -200
        labels = [-100] * 2 + ids[2:]
        f = (1 if -200 in ids else 0) if frames else 0
        out.append({"input_ids": ids, "labels": labels,
                    "pixel_values": rng.standard_normal(
                        (f, 3, 4, 4)).astype(np.float32)})
    return out


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if want[k] is None:
            assert g is None, k
            continue
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


# --------------------------------------------------------------------------
# samplers, the index stream, collation and packing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch,dp", [(0, 2, 1), (3, 4, 1), (1, 2, 2)])
def test_samplers_match_reference(seed, batch, dp):
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(-50, 50, size=137)]
    for epoch in (0, 1, 5):
        for rank in range(dp):
            a = jsampler.LengthGroupedSampler(lengths, batch, seed=seed,
                                              dp_rank=rank, dp_size=dp)
            b = tsampler.LengthGroupedSampler(lengths, batch, seed=seed,
                                              dp_rank=rank, dp_size=dp)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)
            a = jsampler.ParallelSampler(137, rank, dp, seed=seed)
            b = tsampler.ParallelSampler(137, rank, dp, seed=seed)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)
    assert (list(jsampler.batched(range(7), 3, drop_last=False))
            == list(tsampler.batched(range(7), 3, drop_last=False)))


@pytest.mark.parametrize("start", [0, 1, 3, 4, 7, 12])
def test_index_stream_resumes_like_reference(start):
    lengths = list(range(-5, 6))
    a = jprefetch.index_stream(jsampler.LengthGroupedSampler(lengths, 3), 3,
                               start_step=start)
    b = tprefetch.index_stream(tsampler.LengthGroupedSampler(lengths, 3), 3,
                               start_step=start)
    assert [next(a) for _ in range(8)] == [next(b) for _ in range(8)]
    # a resumed stream continues the uninterrupted one
    full = tprefetch.index_stream(tsampler.LengthGroupedSampler(lengths, 3),
                                  3)
    straight = [next(full) for _ in range(start + 4)]
    again = tprefetch.index_stream(tsampler.LengthGroupedSampler(lengths, 3),
                                   3, start_step=start)
    assert straight[start:] == [next(again) for _ in range(4)]


@pytest.mark.parametrize("kw", [{}, {"max_length": 40},
                                {"sequence_parallel_size": 4},
                                {"pad_token_id": 7}])
def test_default_collate_matches_reference(kw):
    samples = _samples(np.random.default_rng(1))
    _equal(tcollate.default_collate_fn(samples, **kw),
           jcollate.default_collate_fn(samples, **kw))
    # frames on the device (torch) collate to the same values
    tsamples = [dict(s, pixel_values=torch.from_numpy(s["pixel_values"]))
                for s in samples]
    _equal(tcollate.default_collate_fn(tsamples, **kw),
           jcollate.default_collate_fn(samples, **kw))
    text = _samples(np.random.default_rng(2), frames=False)
    got = tcollate.default_collate_fn(text, **kw)
    assert "pixel_values" not in got
    _equal(got, jcollate.default_collate_fn(text, **kw))


@pytest.mark.parametrize("pack", [8, 32, 64])
def test_soft_packer_matches_reference(pack):
    samples = [{k: s[k] for k in ("input_ids", "labels")}
               for s in _samples(np.random.default_rng(3), n=12)]
    a = jcollate.SoftPacker(samples, pack)
    b = tcollate.SoftPacker(samples, pack)
    assert len(a) == len(b)
    for i in range(len(a)):
        _equal(b[i], a[i])
    _equal(tcollate.packed_collate_fn([b[i] for i in range(len(b))]),
           jcollate.packed_collate_fn([a[i] for i in range(len(a))]))


@pytest.mark.parametrize("pack,nvis", [(40, 5), (64, 9), (120, 3)])
def test_soft_packer_mm_matches_reference(pack, nvis):
    samples = _samples(np.random.default_rng(4), n=14)
    a = jcollate.SoftPackerMM(samples, pack, n_visual_tokens=nvis)
    b = tcollate.SoftPackerMM(samples, pack, n_visual_tokens=nvis)
    assert len(a) == len(b) and len(a) > 1
    pa = [a[i] for i in range(len(a))]
    pb = [b[i] for i in range(len(b))]
    for x, y in zip(pb, pa):
        _equal(x, y)
    for sel in (slice(0, 2), slice(1, 4), slice(None)):
        _equal(tcollate.packed_collate_mm(pb[sel]),
               jcollate.packed_collate_mm(pa[sel]))
    # the port's frames as torch tensors collate to the same values
    tb = tcollate.SoftPackerMM(
        [dict(s, pixel_values=torch.from_numpy(s["pixel_values"]))
         for s in samples], pack, n_visual_tokens=nvis)
    _equal(tcollate.packed_collate_mm([tb[i] for i in range(len(tb))]),
           jcollate.packed_collate_mm(pa))
    with pytest.raises(ValueError):
        tcollate.SoftPackerMM(samples, 8, n_visual_tokens=nvis)


def test_pad_for_sequence_parallel_matches_reference():
    x = np.arange(20, dtype=np.int32).reshape(2, 10)
    for sp in (1, 3, 4, 5):
        np.testing.assert_array_equal(
            tcollate.pad_for_sequence_parallel(x, sp, -1),
            jcollate.pad_for_sequence_parallel(x, sp, -1))


def test_prefetcher_yields_the_stream_in_order():
    def fetch(i):
        return {"x": np.full((2,), i)}

    def collate(items):
        return np.stack([it["x"] for it in items])

    lengths = list(range(1, 23))
    sampler = tsampler.LengthGroupedSampler(lengths, 4, seed=5)
    want = [collate([fetch(i) for i in idx]) for idx in
            (lambda s: [next(s) for _ in range(9)])(
                tprefetch.index_stream(sampler, 4, start_step=2))]
    with tprefetch.BatchPrefetcher(
            tprefetch.index_stream(sampler, 4, start_step=2), fetch,
            collate, depth=3, workers=3, device="cpu") as pf:
        got = [next(pf) for _ in range(9)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    def boom(i):
        raise KeyError(i)

    with tprefetch.BatchPrefetcher([[1]], boom, collate) as pf:
        with pytest.raises(KeyError):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)


# --------------------------------------------------------------------------
# packed batches: the fusion's segments and the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [(3,), (1, 4)])
def test_fuse_multimodal_segments_match_jax(groups):
    rng = np.random.default_rng(len(groups))
    B, T, D, F = 2, 24, 8, sum(1 for _ in groups)
    table = rng.standard_normal((40, D)).astype(np.float32)
    ids = rng.integers(3, 40, size=(B, T))
    segs = np.full((B, T), -1, np.int32)
    mask = np.zeros((B, T), bool)
    n_frames = 3
    for b, (cuts, n) in enumerate((((0, 7, 15), 20), ((0, 9), 24))):
        mask[b, :n] = True
        for s, c in enumerate(cuts):
            segs[b, c:n] = s
    # frame markers: row 0 three, row 1 two (its third frame is padding)
    ids[0, [1, 8, 16]] = IMAGE_TOKEN_INDEX
    ids[1, [2, 10]] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
    if len(groups) == 1:
        vis = [rng.standard_normal((B, n_frames, groups[0], D))]
    else:
        vis = [rng.standard_normal((B, 1, groups[0], D)),
               rng.standard_normal((B, n_frames - 1, groups[1], D))]
    vis = [v.astype(np.float32) for v in vis]
    want = jaurora.fuse_multimodal(
        jnp.asarray(table), jnp.asarray(ids), [jnp.asarray(v) for v in vis],
        jnp.asarray(mask), jnp.asarray(labels), segment_ids=jnp.asarray(segs))
    got = taurora.fuse_multimodal(
        torch.from_numpy(table), torch.from_numpy(ids),
        [torch.from_numpy(v) for v in vis], torch.from_numpy(mask),
        torch.from_numpy(labels), torch.from_numpy(segs))
    for k in ("inputs_embeds", "attention_mask", "position_ids", "labels",
              "segment_ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["segment_ids"].numpy().max(axis=1) >= 1).all()


def test_packed_loss_matches_jax_and_the_unpacked_documents():
    """A packed multimodal batch (SoftPackerMM → packed_collate_mm)
    through aurora_forward: the port's loss equals the JAX loss, and both
    equal the loss of the same documents unpacked (the reference's mean
    over the valid tokens counts the same tokens; each document starts
    with an ignored label, so no prediction crosses a boundary), fp32."""
    cfg = jaurora.AuroraConfig.tiny()
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: {
        "visual_encoder": init_vit_params(key, cfg.vit),
        "projector": init_projector_params(key, cfg.projector),
        "llm": init_llama_params(key, cfg.llm)})

    def leaf(path, s):     # norm scales 1 + noise, other weights noise
        name = jax.tree_util.keystr(path)
        if "norm" in name or "scale" in name or name.endswith("ln1']") \
                or "'ln" in name:
            base = np.ones(s.shape)
        else:
            base = np.zeros(s.shape)
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(s.dtype)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    model = bridge.aurora_from_params(tree, bridge.aurora_config_from(cfg),
                                      dtype=torch.float32, device="cpu")
    kept = 0.5
    n_vis = jaurora.num_visual_tokens(cfg, kept, 56, 56)
    samples = []
    for n in (9, 14, 6, 11, 8):
        ids = [1] + rng.integers(3, 250, size=n).tolist()
        ids[2] = IMAGE_TOKEN_INDEX
        labels = [-100] * 3 + ids[3:]
        samples.append({"input_ids": ids, "labels": labels,
                        "pixel_values": rng.standard_normal(
                            (1, 3, 56, 56)).astype(np.float32)})
    packer = tcollate.SoftPackerMM(samples, 2 * n_vis + 30,
                                   n_visual_tokens=n_vis)
    packs = [packer[i] for i in range(len(packer))]
    assert max(len(set(p["segment_ids"].tolist())) for p in packs) >= 2
    batch = tcollate.packed_collate_mm(packs)
    assert batch["pixel_values"].shape[1] >= 2

    def loss_jax(b):
        return jax.jit(lambda p, x: jaurora.aurora_forward(
            p, cfg, x["input_ids"], x["pixel_values"],
            attention_mask=x["attention_mask"], labels=x["labels"],
            kept_ratio=kept, mode="loss",
            segment_ids=x.get("segment_ids")))(
                tree, {k: jnp.asarray(v) for k, v in b.items()})

    def loss_port(b):
        t = {k: torch.as_tensor(v) for k, v in b.items()}
        return taurora.aurora_forward(
            model, t["input_ids"].long(), t["pixel_values"],
            attention_mask=t["attention_mask"], labels=t["labels"].long(),
            kept_ratio=kept, mode="loss", segment_ids=t.get("segment_ids"))

    want, n_want = loss_jax(batch)
    got, n_got = loss_port(batch)
    assert int(n_got) == int(n_want)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    flat = tcollate.default_collate_fn(samples)
    unpacked, n_un = loss_port(flat)
    assert int(n_un) == int(n_got)
    np.testing.assert_allclose(float(unpacked.detach()), float(got.detach()),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# map fns, tokenization and the dataset
# --------------------------------------------------------------------------

RECORDS = [
    {"image": "a.png", "conversations": [
        {"from": "human", "value": "<image>\nWhat is shown?"},
        {"from": "gpt", "value": "A cat on a mat."},
        {"from": "human", "value": "And then?"},
        {"from": "gpt", "value": "It sleeps."}]},
    {"image": ["a.png", "b.png", "c.png"], "conversations": [
        {"from": "gpt", "value": "dropped"},
        {"from": "human", "value": "<image> <image> <image> Describe."},
        {"from": "gpt", "value": "Three frames."},
        {"from": "human", "value": "trailing, dropped"}]},
    {"conversations": [
        {"from": "human", "value": "Just text?"},
        {"from": "gpt", "value": "Yes, just text."}]},
    {"image": "missing.png", "conversations": [
        {"from": "human", "value": "<image> here"},
        {"from": "gpt", "value": "Nothing."}]},
]


def test_map_fns_match_reference():
    for rec in RECORDS:
        assert tdataset.aurora_map_fn(rec) == jdataset.aurora_map_fn(rec)
        if rec is RECORDS[0] or "image" not in rec:
            # a human turn without a marker: the reference asserts
            with pytest.raises(AssertionError):
                jdataset.aurora_image_only_map_fn(rec)
            with pytest.raises(ValueError):
                tdataset.aurora_image_only_map_fn(rec)
        else:
            assert (tdataset.aurora_image_only_map_fn(rec)
                    == jdataset.aurora_image_only_map_fn(rec))
        ex = jdataset.aurora_map_fn(rec)
        for name in ("vicuna", "default"):
            tpl = getattr(PROMPT_TEMPLATE, name)
            for system in ("", "Be brief."):
                assert (tdataset.template_map_fn(ex, tpl, system)
                        == jdataset.template_map_fn(ex, tpl, system))
    with pytest.raises(ValueError):
        tdataset.aurora_map_fn({"conversations": [
            {"from": "robot", "value": "x"}, {"from": "gpt", "value": "y"}]})


def _smooth(h, w, phase=0.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        127 + 120 * np.sin(xx / 9.0 + phase) * np.cos(yy / 7.0),
        127 + 110 * np.cos(xx / 13.0 + 1.0 + phase),
        127 + 100 * np.sin((xx + yy) / 17.0)], axis=-1)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    for name, (h, w, ph) in {"a.png": (50, 90, 0.0), "b.png": (120, 80, 1.0),
                             "c.png": (56, 56, 2.0)}.items():
        Image.fromarray(_smooth(h, w, ph)).save(d / name)
    return d


def _write_records(path, records):
    with open(path, "w") as f:
        json.dump(records, f)


@pytest.mark.parametrize("max_length", [16, 4096])
def test_dataset_text_data_matches_reference(tok, tmp_path, image_dir,
                                             max_length):
    path = tmp_path / "d.json"
    _write_records(path, RECORDS)
    kw = dict(image_folder=str(image_dir), template=PROMPT_TEMPLATE.vicuna,
              max_length=max_length, image_size=56)
    ref = jdataset.AuroraDataset(str(path), tok, **kw)
    got = tdataset.AuroraDataset(str(path), tok, device="cpu", **kw)
    assert got.text_data == ref.text_data
    assert got.modality_length() == ref.modality_length()
    # jsonl and the image-only map fn (records whose every human turn
    # carries a marker)
    path = tmp_path / "d.jsonl"
    kw["map_fn"] = jdataset.aurora_image_only_map_fn
    recs = RECORDS[1:2] + RECORDS[3:]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    ref = jdataset.AuroraDataset(str(path), tok, **kw)
    kw["map_fn"] = tdataset.aurora_image_only_map_fn
    got = tdataset.AuroraDataset(str(path), tok, device="cpu", **kw)
    assert got.text_data == ref.text_data


def test_tokenization_cache_is_the_reference_format(tok, tmp_path):
    path = tmp_path / "d.json"
    _write_records(path, RECORDS)
    cache = tmp_path / "cache"
    ref = jdataset.AuroraDataset(str(path), tok,
                                 template=PROMPT_TEMPLATE.vicuna,
                                 cache_dir=str(cache))
    (name,) = os.listdir(cache)
    # the port reads the reference's cache file (same key), and a cache
    # hit needs no tokenizer
    got = tdataset.AuroraDataset(str(path), None,
                                 template=PROMPT_TEMPLATE.vicuna,
                                 cache_dir=str(cache), device="cpu")
    assert got.text_data == ref.text_data
    os.remove(cache / name)
    tdataset.AuroraDataset(str(path), tok, template=PROMPT_TEMPLATE.vicuna,
                           cache_dir=str(cache), device="cpu")
    assert os.listdir(cache) == [name]
    with open(cache / name) as f:
        assert json.load(f) == ref.text_data


@pytest.mark.parametrize("square,aspect", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_dataset_frames_within_two_levels_of_pil(tok, tmp_path, image_dir,
                                                 square, aspect):
    recs = RECORDS[:2]
    if aspect:      # frames of a sample must stack: one image a sample
        recs = [dict(RECORDS[0], image=f) for f in ("a.png", "b.png",
                                                     "c.png", "a.png")]
    path = tmp_path / "d.json"
    _write_records(path, recs)
    kw = dict(image_folder=str(image_dir), template=PROMPT_TEMPLATE.vicuna,
              image_size=56, pad_image_to_square=square,
              keep_aspect_ratio=aspect)
    ref = jdataset.AuroraDataset(str(path), tok, **kw)
    got = tdataset.AuroraDataset(str(path), tok, device="cpu", **kw)
    n = 0
    for i in range(len(recs)):
        want = ref[i]["pixel_values"]
        px = got[i]["pixel_values"]
        assert px.dtype == torch.float32 and px.device.type == "cpu"
        assert tuple(px.shape) == want.shape
        # normalized values back to levels of 1/255 before normalization
        diff = np.abs(px.numpy() - want) * STD
        assert diff.max() <= PIXEL_TOL + 1e-6, diff.max() * 255
        n += len(want)
    assert n == 4


def test_missing_and_undecodable_files_give_zero_frames(tok, tmp_path,
                                                        image_dir):
    (tmp_path / "bad.png").write_bytes(timage.PNG_SIGNATURE + b"\0" * 40)
    (tmp_path / "trunc.png").write_bytes(
        (image_dir / "a.png").read_bytes()[:200])
    recs = [{"image": ["missing.png", "bad.png", "trunc.png", "c.png"],
             "conversations": [{"from": "human", "value": "<image> x"},
                               {"from": "gpt", "value": "y"}]}]
    path = tmp_path / "d.json"
    _write_records(path, recs)
    kw = dict(image_folder=str(tmp_path), image_size=56)
    for f in ("c.png",):
        (tmp_path / f).write_bytes((image_dir / f).read_bytes())
    ref = jdataset.AuroraDataset(str(path), tok, **kw)[0]["pixel_values"]
    got = tdataset.AuroraDataset(str(path), tok, device="cpu",
                                 **kw)[0]["pixel_values"].numpy()
    assert got.shape == ref.shape == (4, 3, 56, 56)
    for k in range(3):
        assert not got[k].any() and not ref[k].any()
    assert np.abs(got[3] - ref[3]).max() * STD.max() <= PIXEL_TOL + 1e-6


def test_a_format_without_a_decoder_raises(tok, tmp_path, monkeypatch):
    from io import BytesIO
    buf = BytesIO()
    Image.fromarray(_smooth(20, 20)).save(buf, format="JPEG")
    (tmp_path / "x.jpg").write_bytes(buf.getvalue())
    # with PIL, the port decodes it as the reference does
    np.testing.assert_array_equal(
        timage.decode_image(buf.getvalue()),
        np.asarray(Image.open(tmp_path / "x.jpg").convert("RGB")))
    recs = [{"image": "x.jpg", "conversations": [
        {"from": "human", "value": "<image> x"}, {"from": "gpt", "value": "y"}]}]
    path = tmp_path / "d.json"
    _write_records(path, recs)
    ds = tdataset.AuroraDataset(str(path), tok, image_folder=str(tmp_path),
                                image_size=56, device="cpu")
    png = BytesIO()
    Image.fromarray(_smooth(9, 7)).save(png, format="PNG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(timage.UnsupportedImageFormat, match="JPEG"):
        ds[0]
    # PNG needs no PIL
    np.testing.assert_array_equal(timage.decode_image(png.getvalue()),
                                  _smooth(9, 7))


# --------------------------------------------------------------------------
# the PNG reader
# --------------------------------------------------------------------------

def _pil_png(img: Image.Image, **kw) -> bytes:
    from io import BytesIO
    buf = BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _noise(rng, h, w, c):
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P4", "P1",
                                  "smooth-RGB", "smooth-L"])
def test_png_reader_equals_pil(mode):
    rng = np.random.default_rng(len(mode))
    h, w = 37, 23
    if mode.startswith("smooth"):
        img = Image.fromarray(_smooth(h, w)).convert(mode.split("-")[1])
    elif mode in ("L", "LA", "RGB", "RGBA"):
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = _noise(rng, h, w, c)
        img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode=mode)
    else:
        colors = {"P": 256, "P4": 16, "P1": 2}[mode]
        img = Image.fromarray(_noise(rng, h, w, 3)).quantize(colors)
    data = _pil_png(img)
    want = np.asarray(Image.open(__import__("io").BytesIO(data))
                      .convert("RGB"))
    np.testing.assert_array_equal(timage.read_png(data), want)


def _encode_png(rows: np.ndarray, ctype: int, filt: int) -> bytes:
    """A PNG of 8-bit rows [H, W·C] with every row filtered by `filt`."""
    h, stride = rows.shape
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    r = rows.astype(np.int64)
    out = []
    for y in range(h):
        cur, up = r[y], (r[y - 1] if y else np.zeros(stride, np.int64))
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if filt == 0:
            pred = np.zeros(stride, np.int64)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = up
        elif filt == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([filt]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    w = stride // bpp

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (timage.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_reader_undoes_every_filter(filt, ctype):
    rng = np.random.default_rng(filt * 10 + ctype)
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    arr = _noise(rng, 11, 13, c)
    data = _encode_png(arr.reshape(11, -1), ctype, filt)
    want = np.asarray(Image.open(__import__("io").BytesIO(data))
                      .convert("RGB"))
    np.testing.assert_array_equal(timage.read_png(data), want)
    with pytest.raises(timage.ImageDecodeError):
        timage.read_png(data[:len(data) // 2])
