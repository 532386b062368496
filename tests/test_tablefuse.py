"""Table-state fusion (core/tablefuse.py): the fused chain must be
bit-identical to running every element's own process (fuse_luts=False),
which the element tests in turn pin against golden/ C transcriptions."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.spec import MediaSpec


HEADLINE = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
            "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV "
            "! zebrastripe ! fakesink")


def _run(launch, img, fuse, window=None, taps=(), set_params=None):
    import jax.numpy as jnp
    p = gt.parse_launch(launch)
    if set_params:
        set_params(p)
    p.negotiate(MediaSpec(kind="video", format="BGRx",
                          width=img.shape[2], height=img.shape[1]))
    p.compile(window or img.shape[0], fuse_luts=fuse, taps=taps)
    res = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    return np.asarray(res[0].data)


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (4, 24, 128, 4), dtype=np.uint8)


def test_headline_chain_fused_bitexact(img):
    """The full 10-element headline chain: one index-plane stencil plus
    table lookups must equal the element-by-element run bit for bit."""
    a = _run(HEADLINE, img, fuse=True)
    b = _run(HEADLINE, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_headline_chain_stateful_phase(img):
    """zebrastripe's stripe phase advances across windows in the fused
    tail exactly like its own process."""
    a = _run(HEADLINE, img, fuse=True, window=2)
    b = _run(HEADLINE, img, fuse=False, window=2)
    np.testing.assert_array_equal(a, b)


def test_dilate_erode_on_index_plane(img):
    """erode=true flips the comparison in the rank domain identically."""
    chain = ("coloreffects preset=sepia ! solarize ! dilate erode=true "
             "! videoconvert format=AYUV ! zebrastripe ! fakesink")
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_word_map_without_head(img):
    """exclusion/chromahold with no upstream index plane fall back to
    their per-pixel process (still bit-exact, just unfused)."""
    chain = "exclusion ! chromahold ! fakesink"
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_head_then_stencil_without_tail(img):
    """A chain that ends mid-stream (no zebrastripe) materializes the
    index-plane state correctly."""
    chain = "coloreffects preset=sepia ! burn ! dilate ! exclusion ! fakesink"
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_taps_break_the_chain(img):
    """A debug tap on an interior node must still see that node's own
    output under full fusion."""
    import jax.numpy as jnp
    from gstbad.golden import coloreffects as g_ce
    from gstbad.golden import gaudieffects as g

    p = gt.parse_launch("coloreffects preset=sepia name=ce ! solarize "
                        "! exclusion name=ex ! dilate ! fakesink")
    p.negotiate(MediaSpec(kind="video", format="BGRx",
                          width=img.shape[2], height=img.shape[1]))
    step = p.compile(img.shape[0], taps=["ex"])
    states = p.init_states(img.shape[0])
    _, leaf_batches, _ = step(p.params(), states,
                              FrameBatch.make(jnp.asarray(img)))
    tap = np.asarray(p.taps_of(leaf_batches)["ex"].data)
    want = np.stack([
        g.exclusion(g.solarize(g_ce.coloreffects_rgb(f, "sepia", (2, 1, 0))))
        for f in img])
    np.testing.assert_array_equal(tap, want)


def test_per_frame_controllable_tables(img):
    """Controllable per-frame params ([B] arrays) give [B, 256] tables all
    through the fused chain — same output as the unfused run."""
    def controls(p):
        for el in p.elements:
            if el.NAME == "solarize":
                el.set_control("threshold",
                               lambda pts: 60 + (pts // 33333333) % 80)
            if el.NAME == "exclusion":
                el.set_control("factor",
                               lambda pts: 100 + (pts // 33333333) % 60)
            if el.NAME == "zebrastripe":
                el.set_control("threshold",
                               lambda pts: 40 + (pts // 33333333) % 50)

    a = _run(HEADLINE, img, fuse=True, set_params=controls)
    b = _run(HEADLINE, img, fuse=False, set_params=controls)
    np.testing.assert_array_equal(a, b)


def test_apply_word_table_gather(rng):
    """Whole-word table lookup (ops/lut.apply_word_table) == numpy
    indexing, on any plane shape."""
    import jax.numpy as jnp
    from gstbad.ops import lut

    table = jnp.asarray(
        rng.integers(-2**31, 2**31, 256, dtype=np.int64).astype(np.int32))
    idx = jnp.asarray(rng.integers(0, 256, (2, 16, 250), dtype=np.int64)
                      .astype(np.int32))
    got = np.asarray(lut.apply_word_table(idx, table))
    want = np.asarray(table)[np.asarray(idx)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("erode", [False, True])
def test_dilate_zebra_tail_fused_vs_unfused(img, erode):
    """The dilate stencil on the index plane followed by zebrastripe's
    table tail == element-by-element, for dilate and erode."""
    chain = (f"coloreffects preset=sepia ! solarize ! dilate erode={erode} "
             "! chromahold ! videoconvert format=AYUV ! zebrastripe "
             "threshold=40 ! fakesink")
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_bars_source_headline_graph():
    """The actual benchmark graph (videotestsrc-driven) fused vs unfused."""
    outs = {}
    for fuse in (True, False):
        p = gt.parse_launch(
            "videotestsrc pattern=bars width=128 height=32 format=BGRx ! "
            + HEADLINE)
        p.negotiate()
        p.compile(4, fuse_luts=fuse)
        res = p.run(n_frames=8, window=4)
        outs[fuse] = np.concatenate([np.asarray(b.data) for b in res])
    np.testing.assert_array_equal(outs[True], outs[False])


def test_rgb_permute_convert_in_chain(img):
    """videoconvert BGRx->RGBx inside a fused chain is a word byte
    shuffle evaluated on the tables."""
    chain = ("coloreffects preset=sepia ! burn ! videoconvert format=RGBx "
             "! exclusion ! fakesink")
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_non_luma_preset_byte_map_chain(img):
    """xpro maps each channel through its own LUT column (byte_map path
    with an identity fill kind) and composes with downstream word maps."""
    chain = ("coloreffects preset=xpro ! solarize ! exclusion ! dilate "
             "! chromahold ! fakesink")
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_chromahold_achromatic_target_in_chain(img):
    """target r==g==b gives hue -1 (gstchromahold.c:271-299 G_MAXUINT) —
    everything greys; table evaluation must match per-pixel."""
    chain = ("coloreffects preset=sepia ! burn ! chromahold target-r=90 "
             "target-g=90 target-b=90 ! videoconvert format=AYUV "
             "! zebrastripe ! fakesink")
    a = _run(chain, img, fuse=True)
    b = _run(chain, img, fuse=False)
    np.testing.assert_array_equal(a, b)


def test_time_invariant_chain_broadcast_source():
    """A static videotestsrc pattern attaches a [1, H, W] broadcast word
    base; a stencil-free chain then computes one frame and broadcasts it.
    Same frames as the unfused run."""
    launch = ("videotestsrc pattern=bars width=96 height=16 format=BGRx ! "
              "coloreffects preset=sepia ! solarize ! exclusion ! fakesink")
    outs = {}
    for fuse in (True, False):
        p = gt.parse_launch(launch)
        p.negotiate()
        p.compile(3, fuse_luts=fuse)
        res = p.run(n_frames=6, window=3)
        outs[fuse] = np.concatenate([np.asarray(b.data) for b in res])
    np.testing.assert_array_equal(outs[True], outs[False])
    np.testing.assert_array_equal(outs[True][0], outs[True][-1])


def test_fused_pipeline_word_sink():
    """The fused program (Pipeline.compile + the word-keeping fakesink)
    is bit-exact vs the unfused element-by-element run, and run()
    restores uint8 frames."""
    launch = ("videotestsrc pattern=bars width=256 height=32 format=BGRx ! "
              + HEADLINE)
    outs = {}
    for fuse in (True, False):
        p = gt.parse_launch(launch)
        p.negotiate()
        p.compile(4, fuse_luts=fuse)
        res = p.run(n_frames=8, window=4)
        outs[fuse] = np.concatenate([np.asarray(b.data) for b in res])
        assert outs[fuse].dtype == np.uint8
    np.testing.assert_array_equal(outs[True], outs[False])


def _chain_reference(src, key_t, word_t, index_fn, erode, thr, phase):
    """The fused tail step by step in numpy: luma index, rank-keyed
    dilate3 walk, word-table materialize, stripe select."""
    from gstbad.core.tablefuse import TableChain
    idx = np.asarray(index_fn(src))
    rank = np.asarray(TableChain.rank_table(key_t))[idx]

    def shift_down(p):
        return np.concatenate([p[:, 1:, :], p[:, -1:, :]], axis=1)

    def shift_right(p):
        return np.concatenate([p[:, :, 1:], p[:, :, -1:]], axis=2)

    def shift_left(p):
        return np.concatenate([p[:, :, :1], p[:, :, :-1]], axis=2)

    oi, ok = idx.copy(), rank.copy()
    for s in (shift_down, shift_right, shift_left):
        ni, nk = s(idx), s(rank)
        take = (nk < ok) if erode else (nk > ok)
        oi = np.where(take, ni, oi)
        ok = np.where(take, nk, ok)
    word = np.asarray(word_t)[oi]
    y = (word >> 8) & 255
    h, w = src.shape[-2:]
    ii = np.arange(w)[None, None, :]
    jj = np.arange(h)[None, :, None]
    stripe = ((ii + jj + np.asarray(phase)[:, None, None]) & 4) != 0
    zebra = (word & np.int32(np.uint32(0xFFFF00FF))) | (16 << 8)
    return np.where(stripe & (y >= thr), zebra, word)


def _luma_index(word):
    from gstbad.ops import pointops
    r = pointops.byte_of(word, 2)
    g = pointops.byte_of(word, 1)
    bb = pointops.byte_of(word, 0)
    return (((r << 8) * 54) + ((g << 8) * 183) + ((bb << 8) * 19)) >> 16


def _random_tables(rng, shape):
    import jax.numpy as jnp
    src = jnp.asarray(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                      .astype(np.int32))
    word_t = jnp.asarray(rng.integers(-2**31, 2**31, 256, dtype=np.int64)
                         .astype(np.int32))
    key_t = jnp.asarray(rng.integers(0, 60000, 256, dtype=np.int64)
                        .astype(np.int32))
    return src, word_t, key_t


@pytest.mark.parametrize("erode", [False, True])
@pytest.mark.parametrize("shape", [(3, 16, 256), (2, 9, 130)])
def test_dilate_zebra_kernel_interpret(rng, erode, shape):
    """The fused tail kernel (ops/chainfuse.py, interpret mode here) ==
    the step-by-step formulation, including frames whose pixel count is
    not a multiple of the kernel's pixel run."""
    import jax.numpy as jnp
    from gstbad.core.tablefuse import TableChain
    from gstbad.ops import chainfuse

    src, word_t, key_t = _random_tables(rng, shape)
    phase = jnp.arange(shape[0], dtype=jnp.int32) + 5
    got = np.asarray(chainfuse.dilate_zebra_fused(
        src, TableChain.rank_table(key_t), word_t, _luma_index,
        jnp.bool_(erode), jnp.int32(120), phase, interpret=True))
    np.testing.assert_array_equal(got, _chain_reference(
        src, key_t, word_t, _luma_index, erode, 120, phase))


def test_dilate_zebra_kernel_broadcast_source(rng):
    """A [1, H, W] broadcast base + batch=B (the videotestsrc static
    pattern path) == the materialized [B, H, W] run."""
    import jax.numpy as jnp
    from gstbad.core.tablefuse import TableChain
    from gstbad.ops import chainfuse

    b, h, w = 4, 16, 256
    src1, word_t, key_t = _random_tables(rng, (1, h, w))
    phase = jnp.arange(b, dtype=jnp.int32) + 5
    args = (TableChain.rank_table(key_t), word_t, _luma_index,
            jnp.bool_(False), jnp.int32(120), phase)
    a = np.asarray(chainfuse.dilate_zebra_fused(src1, *args, batch=b,
                                                interpret=True))
    bb = np.asarray(chainfuse.dilate_zebra_fused(
        jnp.broadcast_to(src1, (b, h, w)), *args, interpret=True))
    np.testing.assert_array_equal(a, bb)


def test_fused_kernel_pipeline(monkeypatch):
    """The headline graph with zebrastripe's tail on the GPU kernel
    (forced here, interpret mode) == the element-by-element run."""
    import functools
    from gstbad.ops import chainfuse

    launch = ("videotestsrc pattern=bars width=200 height=24 format=BGRx ! "
              + HEADLINE)
    outs = {}
    for mode in ("kernel", "unfused"):
        with monkeypatch.context() as m:
            if mode == "kernel":
                m.setattr(chainfuse, "_use_kernel", lambda: True)
                m.setattr(chainfuse, "dilate_zebra_fused",
                          functools.partial(chainfuse.dilate_zebra_fused,
                                            interpret=True))
            p = gt.parse_launch(launch)
            p.negotiate()
            p.compile(4, fuse_luts=mode == "kernel")
            res = p.run(n_frames=8, window=4)
        outs[mode] = np.concatenate([np.asarray(b.data) for b in res])
    np.testing.assert_array_equal(outs["kernel"], outs["unfused"])


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False),
                                          ("metal", None)])
def test_chainfuse_backend_choice(monkeypatch, backend, want):
    import jax
    from gstbad.ops import chainfuse

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(NotImplementedError, match="backend"):
            chainfuse._use_kernel()
    else:
        assert chainfuse._use_kernel() is want


def test_dilate_zebra_kernel_lowers_for_cuda(rng):
    """Every primitive of the fused tail (the traced luma index
    included) has a Triton lowering."""
    import jax
    import jax.numpy as jnp
    from gstbad.core.tablefuse import TableChain
    from gstbad.ops import chainfuse

    src, word_t, key_t = _random_tables(rng, (1, 1080, 1920))
    f = jax.jit(lambda s: chainfuse.dilate_zebra_fused(
        s, TableChain.rank_table(key_t), word_t, _luma_index,
        jnp.bool_(False), jnp.int32(120), jnp.arange(4, dtype=jnp.int32),
        batch=4))
    text = f.trace(src).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text


@pytest.mark.gpu
def test_dilate_zebra_kernel_on_card(gpu, rng):
    """The fused tail compiled for the card == the numpy formulation at
    1080p, over a broadcast source."""
    import jax.numpy as jnp
    from gstbad.core.tablefuse import TableChain
    from gstbad.ops import chainfuse

    src1, word_t, key_t = _random_tables(rng, (1, 1080, 1920))
    phase = jnp.arange(3, dtype=jnp.int32)
    got = np.asarray(chainfuse.dilate_zebra_fused(
        src1, TableChain.rank_table(key_t), word_t, _luma_index,
        jnp.bool_(True), jnp.int32(90), phase, batch=3))
    np.testing.assert_array_equal(got, _chain_reference(
        np.broadcast_to(np.asarray(src1), (3, 1080, 1920)), key_t, word_t,
        _luma_index, True, 90, phase))
