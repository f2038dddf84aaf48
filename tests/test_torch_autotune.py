"""The tile autotuners of the GEMM and flash-forward kernels
(`kernels.gemm.autotune_gemm`, `kernels.flash_attention.autotune_flash`)
and how a call resolves its tile, against the JAX package's
(tpusparse/kernels/gemm.py:175-295, flash_attention.py:319-418): both
raise without their device, the saved tiles' keys are JAX's strings, and a
call takes an explicit tile, else the one saved for this card, else the
kernel's own. The calibration file is a temporary one
(`TPUSPARSE_TORCH_CALIBRATION`); on the CPU the tiles are stamped 'cpu',
the name the port gives a machine without a card. tests/test_torch_cuda.py
holds the tiles' outputs bitwise equal on the card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import flash_attention as jfa
from tpusparse.kernels import gemm as jgemm

from tpusparse_torch.kernels import flash_attention as fa
from tpusparse_torch.kernels import gemm as gk
from tpusparse_torch.utils import calibrate
from tpusparse_torch.utils.config import dtype_name

CSRC = Path(gk.__file__).resolve().parents[1] / "csrc"


def _reread():
    """Empty the tile caches, so that the next lookup reads the file."""
    gk._TILE_CACHE.clear()
    fa._FLASH_TILE_CACHE.clear()
    gk._TILE_CACHE_LOADED = fa._FLASH_TILE_LOADED = False


@pytest.fixture
def tile_file(tmp_path, monkeypatch):
    """A fresh calibration file, read by the next lookup, and the caches
    emptied again after."""
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("TPUSPARSE_TORCH_CALIBRATION", str(path))
    _reread()
    yield path
    _reread()


def test_autotuners_raise_without_the_device_as_jax_does():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        gk.autotune_gemm(64, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        fa.autotune_flash(128, 64, 2)
    with pytest.raises(RuntimeError, match="TPU"):
        jgemm.autotune_gemm(64, 64, 64)
    with pytest.raises(RuntimeError, match="TPU"):
        jfa.autotune_flash(128, 64, 2)


@pytest.mark.parametrize("args", [(4096, 4096, 4096, "bfloat16"), (512, 4096, 4096, "float32"),
                                  (1, 2, 3, "float32")])
def test_gemm_key_is_jax(args):
    m, k, n, dt = args
    assert gk._tile_key(m, k, n, dt) == jgemm._tile_key(m, k, n, dt)
    assert dtype_name(getattr(torch, dt)) == jnp.dtype(getattr(jnp, dt)).name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tier", ["high", "default"])
def test_flash_key_is_jax(causal, tier):
    for bh, s, d, dt in ((96, 512, 64, "float32"), (8, 4096, 128, "bfloat16")):
        assert (fa._flash_tile_key(bh, s, d, dt, causal, tier)
                == jfa._flash_tile_key(bh, s, d, dt, causal, tier))


def test_candidate_tiles():
    """The two block heights by 128 columns, k in the tier's 128-byte chunk;
    the flash forward's 128- and 64-row q-tiles by 64 keys."""
    assert gk.gemm_tiles(torch.float32, precision="high") == [(64, 128, 32), (128, 128, 32)]
    assert gk.gemm_tiles(torch.float32, precision="highest") == [(64, 128, 32), (128, 128, 32)]
    assert gk.gemm_tiles(torch.float32, precision="default") == [(64, 128, 64), (128, 128, 64)]
    assert gk.gemm_tiles(torch.bfloat16) == [(64, 128, 64), (128, 128, 64)]
    assert gk.gemm_tiles(torch.float32, torch.bfloat16, "high") == [(64, 128, 32),
                                                                     (128, 128, 32)]
    assert fa.FLASH_TILES == ((128, 64), (64, 64))


def test_gemm_resolves_explicit_then_saved_then_default(tile_file):
    f32 = torch.float32
    res = lambda **kw: gk.resolve_tile(4096, 4096, 4096, f32, f32, "high", **kw)
    assert res() is None  # nothing saved: the kernel's own height
    calibrate.save_gemm_tile(gk._tile_key(4096, 4096, 4096, "float32"), (64, 128, 32))
    assert res() is None  # read once: the cache was loaded before the save
    _reread()
    assert res() == (64, 128, 32)  # the saved tile
    assert res(block_m=128) == (128, 128, 32)  # explicit over saved
    assert res(block_n=128) is None  # the height left to the kernel
    # the saved tile names another tier's chunk: the 'default' call ignores it
    assert gk.resolve_tile(4096, 4096, 4096, f32, f32, "default") is None
    # another shape or type has no saved tile
    assert gk.resolve_tile(4096, 4096, 2048, f32, f32, "high") is None
    assert gk.resolve_tile(4096, 4096, 4096, torch.bfloat16, torch.bfloat16, "high") is None


def test_gemm_tile_saved_for_another_card_is_ignored(tile_file):
    key = gk._tile_key(256, 256, 256, "float32")
    calibrate.save_gemm_tile(key, (64, 128, 32))
    calibrate.save_tile_entry("gemm_tiles", key, (64, 128, 32), device_name="NVIDIA H100 80GB HBM3")
    f32 = torch.float32
    assert gk.resolve_tile(256, 256, 256, f32, f32, "high") is None


@pytest.mark.parametrize("tile", [dict(block_m=32), dict(block_m=256), dict(block_n=256),
                                  dict(block_k=64), dict(block_m=64, block_k=128)])
def test_gemm_tile_it_lacks_raises(tile):
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with pytest.raises(ValueError, match="its tiles are"):
        gk.gemm_kernel(a, b, precision="high", **tile)


def test_gemm_explicit_tile_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((40, 33)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((33, 10)).astype(np.float32))
    want = gk.gemm_kernel(a, b)
    for bm in gk.BLOCK_MS:
        assert torch.equal(gk.gemm_kernel(a, b, block_m=bm), want)


def test_flash_resolves_explicit_then_saved_then_default(tile_file):
    shape, f32 = (8, 12, 512, 64), torch.float32
    res = lambda *a: fa.resolve_flash_tile(shape, f32, True, "high", *a)
    assert res() is None
    assert res(64, 64) == (64, 64)
    assert res(64) == (64, 64)  # block_k 64, the only one
    assert res(128, 256) is None  # JAX's sizes: accepted and ignored
    key = fa._flash_tile_key(96, 512, 64, "float32", True, "high")
    calibrate.save_tile_entry("flash_tiles", key, (64, 64))
    _reread()
    assert res() == (64, 64)
    assert res(128, 64) == (128, 64)  # explicit over saved
    assert res(512, 512) == (64, 64)  # not a tile of the kernel: the saved one
    assert fa.resolve_flash_tile(shape, f32, False, "high") is None  # other key
    assert fa.resolve_flash_tile(shape, f32, True, "default") is None
    # d > 128 runs the wide kernel, which has its own tile
    assert fa.resolve_flash_tile((8, 12, 512, 192), f32, True, "high", 64, 64) is None


def test_flash_tile_saved_for_another_card_is_ignored(tile_file):
    key = fa._flash_tile_key(4, 256, 32, "float32", False, "high")
    calibrate.save_tile_entry("flash_tiles", key, (64, 64), device_name="NVIDIA H100 80GB HBM3")
    assert fa.resolve_flash_tile((4, 256, 32), torch.float32, False, "high") is None


def test_flash_tiles_and_candidates_are_checked():
    q = torch.randn(1, 64, 16)
    with pytest.raises(ValueError, match="q-tiles"):
        fa.flash_fwd_kernel(q, q, q, sm_scale=0.25, block_q=32)
    with pytest.raises(ValueError, match="no tile"):
        fa.autotune_flash(128, 64, 2, candidates=[(512, 512)])


def test_flash_attention_takes_any_tile_on_the_cpu():
    """A tile moves the kernel's time, not the result: the plain version on
    the CPU gives the same bits for each."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 70, 32)).astype(np.float32))
               for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=True)
    for bq, bk in fa.FLASH_TILES + ((128, 256),):
        assert torch.equal(fa.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk),
                           want)


def _c_params(source: str, name: str) -> int:
    src = (CSRC / source).read_text()
    return len(re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(","))


def test_bindings_match_the_c_entry_points(monkeypatch):
    """A ctypes binding whose argument count differs from its C entry point
    fails only on the card."""
    from tpusparse_torch.kernels import _build

    captured = {}
    monkeypatch.setattr(_build, "bind", lambda name, argtypes: captured.update(argtypes))
    gk._kernel_fns.__wrapped__()
    fa._kernel_fns.__wrapped__()
    assert len(captured["gemm"]) == _c_params("gemm.cu", "gemm") == 15
    assert len(captured["gemm_default_block_m"]) == _c_params("gemm.cu",
                                                               "gemm_default_block_m") == 2
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert len(captured[name]) == _c_params("flash_attention.cu", name)
    assert len(captured["flash_fwd"]) == 17
