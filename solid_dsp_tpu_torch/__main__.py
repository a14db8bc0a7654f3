"""Command-line interface: ``python -m solid_dsp_tpu_torch <command>``.

Port of ``solid_dsp_tpu/__main__.py`` on the port's modules.  The commands
run on the CUDA card unless ``--device`` names another (``--device cpu``
runs the plain PyTorch versions of the kernels):

* ``demo``     -- the reference's main.rs run: a 102,400-sample NCO tone
                  through the PLL active-lag IIR filter (prints the head)
* ``rx``       -- demodulate an IQ recording through ``RxChain``
                  (``--wav [--stereo]`` writes broadcast audio)
* ``spectrum`` -- windowed-FFT spectral analysis of a recording
* ``convert``  -- convert IQ recording formats (rtl_sdr's cu8 included)
* ``monitor``  -- channel-occupancy events over a wideband recording
* ``resample`` -- rate-convert an IQ recording by any real factor
* ``packets``  -- decode framed packet bursts (``PacketModem`` or
                  ``OFDMModem``) from a recording, one JSON line a burst
* ``tx``       -- synthesize an IQ recording with ``TxChain``
* ``adsb``     -- decode ADS-B / Mode S frames from a recording
* ``ais``      -- decode AIS bursts from a GMSK baseband recording

A recording is read by the native runtime's ``StreamPump`` (a C++ reader
thread) in blocks of numpy complex64; each block is copied to the device,
and each result back.  ``-`` reads standard input, so the tool composes
with SDR programs: ``rtl_sdr - | python -m solid_dsp_tpu_torch rx - ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

IQ_CHOICES = ["cf32", "ci16", "ci8", "cf64", "cu8"]

WAITING = """commands of the JAX package that wait for their modules
(ROADMAP.md, queue 1):
  bench           item 6 (the H100 benchmark)"""


def _input_path(name: str) -> str:
    return "/dev/stdin" if name == "-" else name


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _cmd_demo(args) -> int:
    from .design import iirdes
    from .ops.iir import IIRFilter, IIRFilterType
    from .ops.nco import NCO

    n = args.samples
    nco = NCO(device=args.device)
    nco.set_frequency(0.1)
    s, c = nco.sincos_block(n)
    tone = torch.complex(c.to(torch.float64), s.to(torch.float64))

    num, den = iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)
    filt = IIRFilter(num, den, iirtype=IIRFilterType.SECOND_ORDER,
                     dtype=torch.complex128, device=args.device)
    t0 = time.perf_counter()
    out = _host(filt.execute_block(tone))
    dt = time.perf_counter() - t0
    print(f"filtered {n} samples in {dt * 1e3:.2f} ms")
    for i in range(min(5, len(out))):
        print(f"  out[{i}] = {out[i]:.12f}")
    return 0


def _cmd_rx(args) -> int:
    from .models.rx_chain import RxChain
    from .runtime import StreamPump, write_iq

    chain = RxChain(
        carrier_freq=args.carrier, decimation=args.decimation,
        fir_taps=args.taps, demod=args.demod, nco_mode="exact",
        agc_mode="block", dtype=torch.complex64, device=args.device,
    )
    outs = []
    t0 = time.perf_counter()
    nsamp = 0
    with StreamPump(_input_path(args.input), fmt=args.format,
                    block=args.block) as pump:
        for blk in pump:
            # the chain takes whole decimation periods: the recording's
            # ragged end is dropped, and an empty block ends the stream
            if len(blk) % args.decimation:
                blk = blk[: len(blk) - len(blk) % args.decimation]
            if not len(blk):
                break
            outs.append(_host(chain.execute_block(blk)))
            nsamp += len(blk)
    dt = time.perf_counter() - t0
    y = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    print(f"processed {nsamp} samples in {dt:.3f}s "
          f"({nsamp / max(dt, 1e-9) / 1e6:.1f} Msps)", file=sys.stderr)
    if args.output:
        write_iq(args.output, y.astype(np.complex64), "cf32")
        print(f"wrote {len(y)} output samples -> {args.output}",
              file=sys.stderr)
    if args.stereo and not args.wav:
        print("--stereo needs --wav (it selects the WAV decode path)",
              file=sys.stderr)
        return 1
    if args.wav:
        if args.demod not in ("fm", "am"):
            print("--wav needs an audio demod (fm/am)", file=sys.stderr)
            return 1
        if not args.rate:
            print("--wav needs --rate (input sample rate in Hz)",
                  file=sys.stderr)
            return 1
        demod_rate = args.rate / args.decimation
        if args.stereo:
            if args.demod != "fm":
                print("--stereo needs --demod fm", file=sys.stderr)
                return 1
            from .models.fm import fm_stereo_decode

            mpx = torch.as_tensor(y.real.astype(np.float32),
                                  device=chain.device)
            left, right, pilot = fm_stereo_decode(mpx, demod_rate,
                                                  deemphasis_tau=75e-6)
            audio = np.stack([_host(left), _host(right)])
            print(f"stereo pilot amplitude {float(pilot):.3f}",
                  file=sys.stderr)
            n = _write_audio_wav(args.wav, audio, demod_rate,
                                 args.audio_rate, False, args.device)
        else:
            n = _write_audio_wav(args.wav, y.real.astype(np.float32),
                                 demod_rate, args.audio_rate,
                                 args.demod == "fm", args.device)
        print(f"wrote {n} audio samples -> {args.wav} "
              f"({args.audio_rate} Hz s16 "
              f"{'stereo' if args.stereo else 'mono'})", file=sys.stderr)
    return 0


def _write_audio_wav(path: str, audio, rate_in: float, rate_out: int,
                     deemphasis: bool, device) -> int:
    """Demodulated audio at rate_in Hz -> 16-bit PCM WAV at rate_out.

    audio: (N,) mono or (C, N), each channel resampled by its own stream
    (then flushed) and the channels peak-normalized together; ``deemphasis``
    applies the 75 us broadcast-FM one-pole at the audio rate."""
    import wave

    from .ops.resample import ArbitraryResampler

    audio = np.atleast_2d(np.asarray(audio))
    chans = []
    for ch in audio:
        r = ArbitraryResampler(rate_out / rate_in, dtype=torch.complex64,
                               device=device)
        a = _host(r.execute_block(ch.astype(np.complex64)))
        chans.append(np.concatenate([a, _host(r.flush())]).real)
    n = min(len(a) for a in chans)
    a = np.stack([c[:n] for c in chans])          # (C, N)
    if deemphasis and a.size:
        from .ops.iir import iir_apply, iir_init

        alpha = float(np.exp(-1.0 / (75e-6 * rate_out)))
        rows = []
        for ch in a:                     # <= 2 channels
            x = torch.as_tensor(ch.astype(np.complex64), device=device)
            y, _ = iir_apply(np.asarray([1.0 - alpha], np.complex64),
                             np.asarray([-alpha], np.complex64),
                             iir_init(1, device=x.device), x)
            rows.append(_host(y).real)
        a = np.stack(rows)
    peak = float(np.max(np.abs(a))) if a.size else 1.0
    pcm = np.clip(a / (peak or 1.0) * 0.95 * 32767,
                  -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(a.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(rate_out))
        w.writeframes(pcm.T.copy(order="C").tobytes())  # interleaved
    return pcm.shape[-1]


def _cmd_spectrum(args) -> int:
    from .device import resolve_device
    from .ops.fft import windowed_fft
    from .runtime import read_iq

    x = read_iq(args.input, args.format, count=args.nfft)
    if len(x) < args.nfft:
        print(f"recording shorter than nfft ({len(x)} < {args.nfft})",
              file=sys.stderr)
        return 1
    X = _host(windowed_fft(torch.as_tensor(x, device=resolve_device(
        args.device)), window=args.window, nfft=args.nfft))
    psd = 20.0 * np.log10(np.abs(np.fft.fftshift(X)) + 1e-20)
    k = int(psd.argmax())
    print(json.dumps({
        "nfft": args.nfft, "window": args.window,
        "peak_db": round(float(psd.max()), 2),
        "peak_freq": round((k - args.nfft // 2) / args.nfft, 6),
        "noise_floor_db": round(float(np.median(psd)), 2),
    }))
    return 0


def _cmd_convert(args) -> int:
    from .runtime import StreamPump, write_iq

    # block by block: constant memory for captures of any size
    total = 0
    with StreamPump(_input_path(args.input), fmt=args.format,
                    block=args.block) as pump:
        for blk in pump:
            write_iq(args.output, blk, args.out_format, append=total > 0)
            total += len(blk)
    if total == 0:                              # empty input: a valid file
        write_iq(args.output, np.zeros(0, np.complex64), args.out_format)
    print(f"converted {total} samples {args.format} -> "
          f"{args.out_format}", file=sys.stderr)
    return 0


def _cmd_monitor(args) -> int:
    from .models.monitor import SpectrumMonitor
    from .ops.cuda_chan import CHAN_HALO
    from .runtime import StreamPump

    mon = SpectrumMonitor(args.channels, high_db=args.high,
                          low_db=args.low, backend=args.backend,
                          device=args.device)
    # the blocks are cut to whole channel rows, and for the fused
    # channelizer to whole groups of its CHAN_HALO carried rows (the JAX
    # CLI aligns to the channel count only, which its fused channelizer
    # refuses: fault F2)
    align = args.channels * (CHAN_HALO if args.backend == "fused" else 1)
    emitted = 0
    rem = np.zeros(0, np.complex64)     # the alignment carry
    with StreamPump(_input_path(args.input), fmt=args.format,
                    block=args.block) as pump:
        for blk in pump:
            blk = np.concatenate([rem, blk])
            keep = len(blk) - len(blk) % align
            rem = blk[keep:]
            blk = blk[:keep]
            if not len(blk):
                continue
            mon.execute_block(blk)
            while emitted < len(mon.events):
                print(json.dumps(mon.events[emitted]))
                emitted += 1
    print(json.dumps(mon.summary()))
    return 0


def _cmd_resample(args) -> int:
    from .ops.resample import ArbitraryResampler
    from .runtime import StreamPump, write_iq

    if args.rate <= 0:
        print("rate must be positive", file=sys.stderr)
        return 1
    r = ArbitraryResampler(args.rate, fpass=args.fpass,
                           stop_band_attenuation=args.attenuation,
                           device=args.device)
    outs = []
    nsamp = 0
    t0 = time.perf_counter()
    with StreamPump(_input_path(args.input), fmt=args.format,
                    block=args.block) as pump:
        for blk in pump:
            y = _host(r.execute_block(blk))
            if len(y):
                outs.append(y)
            nsamp += len(blk)
    # drain the cascade's group delay and alignment remainder, then cut to
    # the converted length: a one-shot conversion keeps the recording's end
    tail = _host(r.flush())
    if len(tail):
        outs.append(tail)
    dt = time.perf_counter() - t0
    y = np.concatenate(outs) if outs else np.zeros(0, np.complex64)
    y = y[: int(round(nsamp * args.rate))]
    print(f"resampled {nsamp} -> {len(y)} samples (rate {args.rate:g}) "
          f"in {dt:.3f}s ({nsamp / max(dt, 1e-9) / 1e6:.1f} Msps in)",
          file=sys.stderr)
    write_iq(args.output, y.astype(np.complex64), args.out_format)
    return 0


def _cmd_packets(args) -> int:
    from .runtime import read_iq

    x = read_iq(args.input, args.format)
    try:
        if args.phy == "ofdm":
            from .models.ofdm_link import OFDMModem

            modem = OFDMModem(payload_bytes=args.payload_bytes,
                              m=args.order, scheme=args.scheme,
                              fec_scheme=args.fec, device=args.device)
        else:
            from .models.packet import PacketModem

            modem = PacketModem(payload_bytes=args.payload_bytes,
                                m=args.order, scheme=args.scheme,
                                fec_scheme=args.fec, device=args.device)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        results = modem.receive_stream(x, max_bursts=args.max_bursts)
    except ValueError as e:
        # e.g. a capture truncated mid-burst: report instead of crashing
        print(json.dumps({"bursts": 0, "crc_ok": 0,
                          "error": str(e)[:160]}))
        return 0
    n_ok = 0
    for data, info in results:
        row = {"offset": int(info["offset"]),
               "crc_ok": bool(info["crc_ok"])}
        if info["crc_ok"]:
            row["payload_hex"] = data.hex()
            n_ok += 1
        print(json.dumps(row))
    print(json.dumps({"bursts": len(results), "crc_ok": n_ok}))
    return 0


def _cmd_tx(args) -> int:
    """Synthesize an IQ recording with the transmit chain."""
    from .models.tx_chain import TxChain, TxChainConfig
    from .runtime import write_iq

    n = args.samples
    if args.mod == "fm":
        msg = np.sin(2 * np.pi * args.tone * np.arange(n))
    elif args.mod in ("psk", "qam"):
        rng = np.random.default_rng(args.seed)
        k = max(1, int(np.log2(args.order)))
        n -= n % k  # whole symbols only
        msg = rng.integers(0, 2, n)
    else:  # none: a complex test tone
        msg = np.exp(2j * np.pi * args.tone * np.arange(n))
    tx = TxChain(TxChainConfig(modulation=args.mod, order=args.order,
                               carrier_freq=args.carrier,
                               interpolation=args.interp),
                 device=args.device)
    iq = _host(tx.execute_block(torch.from_numpy(msg))).astype(np.complex64)
    write_iq(args.output, iq, args.format)
    print(json.dumps({"output": args.output, "samples": int(len(iq)),
                      "format": args.format, "mod": args.mod,
                      "carrier": args.carrier}))
    return 0


def _cmd_adsb(args) -> int:
    from .models import adsb
    from .runtime import read_iq

    frames = adsb.decode(read_iq(args.input, args.format), sps=args.sps,
                         threshold=args.threshold, device=args.device)
    for fr in frames:
        if fr["crc_ok"] or args.all:
            print(json.dumps({
                "start": fr["start"], "df": fr["df"],
                "icao": f"{fr['icao']:06X}", "crc_ok": fr["crc_ok"],
                "confidence": round(fr["confidence"], 3)}))
    print(json.dumps({"frames": len(frames),
                      "crc_ok": sum(f["crc_ok"] for f in frames)}),
          file=sys.stderr)
    return 0


def _cmd_ais(args) -> int:
    from .models import ais
    from .runtime import read_iq

    frames = ais.ais_receive(read_iq(args.input, args.format), sps=args.sps,
                             device=args.device)
    n_ok = 0
    for payload, ok in frames:
        if not ok and not args.all:
            continue
        n_ok += bool(ok)
        row = {"crc_ok": bool(ok), "bits": int(len(payload))}
        if len(payload) >= 168:
            row.update(ais.parse_type123(payload[:168]))
        print(json.dumps(row))
    print(json.dumps({"frames": len(frames), "crc_ok": n_ok}),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="solid_dsp_tpu_torch", epilog=WAITING,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="reference main.rs demo chain")
    d.add_argument("--samples", type=int, default=102_400)
    d.set_defaults(fn=_cmd_demo)

    r = sub.add_parser("rx", help="demodulate an IQ recording")
    r.add_argument("input")
    r.add_argument("-o", "--output", default=None)
    r.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    r.add_argument("--carrier", type=float, default=0.2)
    r.add_argument("--decimation", type=int, default=4)
    r.add_argument("--taps", type=int, default=64)
    r.add_argument("--demod", default="fm", choices=["fm", "am", "qpsk",
                                                     "none"])
    r.add_argument("--block", type=int, default=1 << 20)
    r.add_argument("--wav", default=None,
                   help="also write demodulated audio as 16-bit mono WAV")
    r.add_argument("--rate", type=float, default=None,
                   help="input sample rate in Hz (required with --wav)")
    r.add_argument("--audio-rate", type=int, default=48000)
    r.add_argument("--stereo", action="store_true",
                   help="decode the broadcast stereo MPX (fm only)")
    r.set_defaults(fn=_cmd_rx)

    s = sub.add_parser("spectrum", help="windowed-FFT analysis")
    s.add_argument("input")
    s.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    s.add_argument("--nfft", type=int, default=4096)
    s.add_argument("--window", default="hamming")
    s.set_defaults(fn=_cmd_spectrum)

    cv = sub.add_parser("convert", help="convert IQ recording formats")
    cv.add_argument("input")
    cv.add_argument("output")
    cv.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    cv.add_argument("--out-format", default="cf32", choices=IQ_CHOICES)
    cv.add_argument("--block", type=int, default=1 << 20)
    cv.set_defaults(fn=_cmd_convert)

    mo = sub.add_parser("monitor",
                        help="channel-occupancy events over a recording")
    mo.add_argument("input")
    mo.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    mo.add_argument("--channels", type=int, default=64)
    mo.add_argument("--high", type=float, default=10.0)
    mo.add_argument("--low", type=float, default=6.0)
    mo.add_argument("--block", type=int, default=1 << 18)
    mo.add_argument("--backend", default="xla", choices=["xla", "fused"],
                    help="filterbank engine: 'fused' = the one-kernel "
                         "channelizer (K4 on the card); blocks are aligned "
                         "to 8*channels for it")
    mo.set_defaults(fn=_cmd_monitor)

    rs = sub.add_parser("resample",
                        help="rate-convert an IQ recording by any factor")
    rs.add_argument("input")
    rs.add_argument("output")
    rs.add_argument("--rate", type=float, required=True,
                    help="f_out / f_in (e.g. 0.5 halves the rate)")
    rs.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    rs.add_argument("--out-format", default="cf32", choices=IQ_CHOICES)
    rs.add_argument("--fpass", type=float, default=0.4)
    rs.add_argument("--attenuation", type=float, default=60.0)
    rs.add_argument("--block", type=int, default=1 << 20)
    rs.set_defaults(fn=_cmd_resample)

    pk = sub.add_parser("packets",
                        help="decode framed packet bursts (JSON lines)")
    pk.add_argument("input")
    pk.add_argument("--phy", default="psk", choices=["psk", "ofdm"])
    pk.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    pk.add_argument("--payload-bytes", type=int, default=64)
    pk.add_argument("--order", type=int, default=4)
    pk.add_argument("--scheme", default="psk",
                    choices=["psk", "qam", "apsk"])
    pk.add_argument("--fec", default="conv",
                    choices=["conv", "ldpc", "polar", "turbo"])
    pk.add_argument("--max-bursts", type=int, default=256)
    pk.set_defaults(fn=_cmd_packets)

    t = sub.add_parser("tx", help="synthesize an IQ recording (TxChain)")
    t.add_argument("output")
    t.add_argument("--mod", default="fm", choices=["fm", "psk", "qam",
                                                   "none"])
    t.add_argument("--order", type=int, default=4)
    t.add_argument("--samples", type=int, default=1 << 16,
                   help="message samples (fm/none) or bits (psk/qam)")
    t.add_argument("--carrier", type=float, default=0.2)
    t.add_argument("--interp", type=int, default=4)
    t.add_argument("--tone", type=float, default=0.002)
    t.add_argument("--format", default="cf32", choices=IQ_CHOICES)
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=_cmd_tx)

    for name, fn, help_ in (("adsb", _cmd_adsb,
                             "decode ADS-B / Mode S frames (power or IQ)"),
                            ("ais", _cmd_ais,
                             "decode AIS bursts (GMSK baseband IQ)")):
        a = sub.add_parser(name, help=help_)
        a.add_argument("input")
        a.add_argument("--format", default="cf32", choices=IQ_CHOICES)
        a.add_argument("--sps", type=int, default=2 if name == "adsb" else 8)
        if name == "adsb":
            a.add_argument("--threshold", type=float, default=0.7)
        a.add_argument("--all", action="store_true",
                       help="also print CRC-failed frames")
        a.set_defaults(fn=fn)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
