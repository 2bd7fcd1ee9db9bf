"""The capture's packed 8-bit IQ carried to the device and unpacked there
(ops/hopper_unpack.py, csrc/unpack.cu; runtime/receiver.py _upload).

On the CPU:
  * the plain unpack (and dsp.as_complex_input on uint16 or int16 words)
    equals unpack_iq_numpy and the native unpack bit for bit, on all
    65,536 words and on a product chunk [32, ngps];
  * replay_blocks yields the file's words, honouring start_stream,
    max_blocks and a short last block;
  * a receiver fed a capture's words gives the EpochInputs, acquisitions
    and states it gives fed the same capture unpacked to complex64; the
    packed run counts rx.packed_blocks = rx.blocks, the complex64 run
    none, and the chunk's upload 2 bytes a sample against 8;
  * acquire_all, snapshot_fix and cli.serve_source give on packed words
    what they give on the unpacked block;
  * a chunk mixing words and complex64 blocks is refused.

On the card (marker cuda, skipped without one; the kernel has no CPU
mode), run with

    python -m pytest tests/test_torch_packed_iq.py -q -m cuda --noconftest

  * the unpack kernel equals the table on all 65,536 words, a product
    chunk, an odd count and a view one word into its storage;
  * a receiver on the card gives bit-identical ChannelOuts, states and
    EpochInputs fed packed or complex64 over three consecutive chunks
    (the pinned staging buffer reused twice), at the small and the
    product configuration."""

import pickle

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode, dsp, hopper_unpack
from gps_sdr_tpu_torch.ops.acquisition import acquire_all
from gps_sdr_tpu_torch.ops.tracking import outs_to_numpy, to_grouped_planar
from gps_sdr_tpu_torch.runtime import _native
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.sources import (pack_iq, replay_blocks,
                                               unpack_iq_numpy)
from gps_sdr_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4,
                       corr_q_window_sec=2, max_sat=3)
PRODUCT = ReceiverConfig(max_sat=12)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(256, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(256, seed=12))]
ALL_WORDS = np.arange(1 << 16, dtype=np.uint16)


def _chunk_words(n_blocks=32, ngps=PRODUCT.ngps, seed=3):
    return np.random.default_rng(seed).integers(
        0, 1 << 16, (n_blocks, ngps), dtype=np.uint16)


def _bits(x) -> np.ndarray:
    """complex64 samples as their float32 bits."""
    return np.ascontiguousarray(x, np.complex64).view(np.uint32)


def _capture(tmp_path, cfg, n_blocks, seed=9) -> str:
    blocks = synth_stream(cfg, SATS, n_blocks, noise_std=0.2, seed=seed)
    path = tmp_path / "capture.bin"
    pack_iq(blocks / np.abs(blocks).max()).tofile(path)
    return str(path)


# --- the unpack ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int16])
@pytest.mark.parametrize("words", ["all", "chunk"])
def test_plain_unpack_equals_host_unpack(words, dtype):
    w = ALL_WORDS if words == "all" else _chunk_words()
    want = unpack_iq_numpy(w)
    t = torch.from_numpy(w).view(dtype)
    got = hopper_unpack.unpack_iq8_plain(t).numpy()
    assert got.shape == w.shape and got.dtype == np.complex64
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(dsp.as_complex_input(t).numpy()),
                                  _bits(want))
    np.testing.assert_array_equal(_bits(_native.unpack_iq(w)), _bits(want))


def test_levels_are_each_byte_in_double_rounded_once():
    v = np.arange(256)
    want = np.array([np.float32(x / 127.5 - 1.0) for x in v.tolist()])
    np.testing.assert_array_equal(hopper_unpack.LEVELS.view(np.uint32),
                                  want.view(np.uint32))
    with pytest.raises(ValueError, match="uint16 or int16"):
        hopper_unpack.unpack_iq8(torch.zeros(4, dtype=torch.int32))


# --- the source -------------------------------------------------------------


@pytest.mark.parametrize("start,max_blocks,want", [
    (0, None, [0, 1, 2, 3, 4]), (2, None, [2, 3, 4]), (1, 2, [1, 2]),
    (4, 10, [4]), (5, None, []), (0, 0, [])])
def test_replay_blocks_yields_the_words(tmp_path, start, max_blocks, want):
    """Five whole blocks and half a sixth: the half block is never
    yielded."""
    cfg = SMALL
    words = _chunk_words(6, cfg.ngps, seed=4)
    path = tmp_path / "cap.bin"
    words.reshape(-1)[:int(5.5 * cfg.ngps)].tofile(path)
    got = list(replay_blocks(str(path), cfg, start_stream=start,
                             max_blocks=max_blocks))
    assert len(got) == len(want)
    for g, i in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (cfg.ngps,)
        np.testing.assert_array_equal(g, words[i])


# --- the receiver -----------------------------------------------------------


def _run(cfg, blocks, device) -> tuple:
    """(EpochInputs pickled, ChannelOuts on the host, found satellites,
    final states, counters) of a receiver over `blocks`, from a clean
    slate of totals."""
    profiling.reset()
    rx = Receiver(cfg, device=device)
    kept = []
    dispatch = rx._dispatch_chunk

    def recording(chunk):
        outs, stream0 = dispatch(chunk)
        kept.append(outs)
        return outs, stream0

    rx._dispatch_chunk = recording
    epochs = [pickle.dumps(e) for e in rx.run(iter(blocks))]
    return (epochs, [outs_to_numpy(o) for o in kept], rx.found_sats,
            [x.cpu() for x in rx.states], profiling.snapshot()["counts"])


def _same_run(packed, cplx) -> None:
    ep_p, outs_p, found_p, st_p, _ = packed
    ep_c, outs_c, found_c, st_c, _ = cplx
    assert found_p == found_c and len(found_p) == len(SATS)
    assert len(outs_p) == len(outs_c) == 3
    for a, b in zip(outs_p, outs_c):
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    for x, y in zip(st_p, st_c):
        assert torch.equal(x, y)
    assert ep_p == ep_c


def _packed_and_complex(tmp_path, cfg, device):
    """A capture of a cold sweep's block and three chunks, the last one
    short, read as words and as their complex64 blocks."""
    path = _capture(tmp_path, cfg, 1 + 3 * cfg.no_sec - 2)
    words = list(replay_blocks(path, cfg))
    return (_run(cfg, words, device),
            _run(cfg, [unpack_iq_numpy(w) for w in words], device))


def test_receiver_same_epochs_packed_or_complex(tmp_path):
    packed, cplx = _packed_and_complex(tmp_path, SMALL, "cpu")
    _same_run(packed, cplx)
    cnt_p, cnt_c = packed[-1], cplx[-1]
    n = 3 * SMALL.no_sec - 2
    assert cnt_p["rx.blocks"] == cnt_c["rx.blocks"] == n
    assert cnt_p["rx.packed_blocks"] == n
    assert cnt_c.get("rx.packed_blocks", 0) == 0
    assert cnt_p["rx.upload_bytes"] == n * SMALL.ngps * 2
    assert cnt_c["rx.upload_bytes"] == n * SMALL.ngps * 8


def test_a_chunk_mixing_words_and_samples_is_refused():
    rx = Receiver(SMALL, device="cpu")
    w = _chunk_words(2, SMALL.ngps)
    with pytest.raises(ValueError, match="mixes packed IQ words"):
        rx._upload([w[0], unpack_iq_numpy(w[1])])


# --- the other consumers of a replayed block -----------------------------


@pytest.mark.parametrize("consumer", ["acquire_all", "snapshot_fix",
                                      "serve_source"])
def test_consumers_take_packed_words(tmp_path, consumer):
    if consumer == "acquire_all":
        cfg = SMALL
        path = _capture(tmp_path, cfg, 2)
        words = next(replay_blocks(path, cfg))
        table = cacode.ca_fft_table(cfg)
        got = acquire_all(cfg, words, table, device="cpu")
        assert sorted(f[1] for f in got) == sorted(s.prn for s in SATS)
        assert got == acquire_all(cfg, unpack_iq_numpy(words), table,
                                  device="cpu")
    elif consumer == "snapshot_fix":
        from gps_sdr_tpu_torch.models.scenario import (make_scenario,
                                                       synth_scenario_blocks)
        from gps_sdr_tpu_torch.ops.snapshot import snapshot_fix
        cfg = PRODUCT
        scn = make_scenario(cfg, n_sats=6, duration_sec=2.0, seed=11)
        block = synth_scenario_blocks(scn, 8, 1, noise_std=0.6, seed=7)[0]
        words = pack_iq(0.25 * block)
        t_rx = scn.t_rx0 + 8 * cfg.ngps / cfg.sample_rate
        ephs = {sat.prn: sat.eph for sat in scn.sats}
        prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])
        kw = dict(prns=sorted(ephs), device="cpu")
        table = cacode.ca_fft_table(cfg)
        got = snapshot_fix(cfg, words, table, ephs, t_rx - 20.0, prior,
                           **kw)
        want = snapshot_fix(cfg, unpack_iq_numpy(words), table, ephs,
                            t_rx - 20.0, prior, **kw)
        assert got is not None and got.n_sat >= 4
        for name in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
    else:
        cfg = SMALL
        t = cfg.no_sec
        path = _capture(tmp_path, cfg, 2 * t + 5)
        want = to_grouped_planar(cfg, torch.from_numpy(np.stack(
            [unpack_iq_numpy(w) for w in replay_blocks(path, cfg)])))
        args = cli.build_parser().parse_args(["serve", path, "--device",
                                              "cpu"])
        provider, n_chunks, _ = cli.serve_source(args, cfg, 0,
                                                 torch.device("cpu"))
        assert n_chunks == 2
        assert torch.equal(provider(0, 2 * t), want[:2 * t])


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the unpack kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all", "chunk", "odd", "offset"])
def test_unpack_kernel_matches_table(cuda, case):
    w = ALL_WORDS if case == "all" else _chunk_words()
    t = torch.from_numpy(w).view(torch.int16).to(cuda)
    if case == "odd":
        w, t = w.reshape(-1)[:12345], t.reshape(-1)[:12345]
    elif case == "offset":
        w, t = w.reshape(-1)[1:], t.reshape(-1)[1:]
    before = hopper_unpack.unpack_iq8.launches
    got = dsp.as_complex_input(t).cpu().numpy()
    assert hopper_unpack.unpack_iq8.launches == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(unpack_iq_numpy(w)))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, PRODUCT], ids=["small", "product"])
def test_receiver_on_card_same_bits_packed_or_complex(cuda, tmp_path, cfg):
    before = hopper_unpack.unpack_iq8.launches
    packed, cplx = _packed_and_complex(tmp_path, cfg, cuda)
    # the cold sweep's block and the three chunks
    assert hopper_unpack.unpack_iq8.launches - before >= 1 + 3
    _same_run(packed, cplx)
    assert packed[-1]["rx.packed_blocks"] == packed[-1]["rx.blocks"]
