"""DemixUI: interactive 4-stem remixing demo.

Port of xumx_slicq_tpu/demixui.py (the reference's Kivy/ALSA toy mixer:
chunked inference, per-stem gain sliders) over the port's Separator, on
the card by default (`--device cpu` for the host). The UI is a terminal
application: a chunked streaming demix that writes the remix to a wav
file. With --interactive on a TTY, per-stem gains are adjustable live from
the keyboard (b/B v/V o/O d/D lower/raise a stem by 0.1, q stops) and level
meters render per chunk; without a TTY, fixed --gains apply.

    python -m xumx_slicq_torch.demixui --input song.wav --output remix.wav \
        --model-path <dir> --gains 1.0 0.0 1.0 1.0        # karaoke: no vocals
"""

import argparse
import sys
import time

import numpy as np

from . import audio as audio_io
from .separator import Separator

STEMS = Separator.sources  # bass, vocals, other, drums
_KEYMAP = {s[0]: i for i, s in enumerate(STEMS)}  # b/v/o/d -> stem index


def stream_demix(separator, audio: np.ndarray, gains, chunk_seconds: float = 10.0):
    """Chunked demix + gain remix generator; yields (chunk_remix, levels).

    `gains` is re-read every chunk, so a caller mutating the sequence
    between iterations (the interactive keyboard loop) changes the mix
    from the next chunk on."""
    sr = int(separator.sample_rate)
    chunk = int(chunk_seconds * sr)
    n = audio.shape[-1]
    for lo in range(0, n, chunk):
        seg = audio[..., lo: lo + chunk]
        est = separator(seg)                        # (4, B, C, n)
        g = np.asarray(gains, np.float32)[:, None, None, None]
        remix = (est * g).sum(0)                    # (B, C, n)
        levels = np.sqrt((est ** 2).mean(axis=(1, 2, 3)))
        yield remix, levels


def apply_key(key: str, gains) -> bool:
    """Apply one keypress to the mutable gains; returns False on quit."""
    if key == "q":
        return False
    idx = _KEYMAP.get(key.lower())
    if idx is not None:
        step = 0.1 if key.isupper() else -0.1
        gains[idx] = float(np.clip(gains[idx] + step, 0.0, 2.0))
    return True


def _drain_keys(gains) -> bool:
    """Consume pending TTY keypresses without blocking; False on quit."""
    import select

    while select.select([sys.stdin], [], [], 0)[0]:
        ch = sys.stdin.read(1)
        if not ch:  # EOF: select reports readable forever, read returns ""
            return True
        if not apply_key(ch, gains):
            return False
    return True


def _render_meters(levels, gains):
    bars = []
    for name, lv, g in zip(STEMS, levels, gains):
        n = int(min(lv * 400, 30))
        bars.append(f"{name:7s} g={g:4.2f} |{'#' * n}{' ' * (30 - n)}|")
    return "\n".join(bars)


def demixui_main(argv=None):
    parser = argparse.ArgumentParser(description="xumx-sliCQ PyTorch demix UI")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, default="remix.wav")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--gains", type=float, nargs=4, default=[1.0, 1.0, 1.0, 1.0],
                        help=f"per-stem gains in order {STEMS}")
    parser.add_argument("--chunk-seconds", type=float, default=10.0)
    parser.add_argument("--interactive", action="store_true", default=False,
                        help="live level meters; on a TTY, keys b/B v/V o/O "
                             "d/D adjust stem gains, q stops")
    args = parser.parse_args(argv)

    separator = Separator.load(model_path=args.model_path, device=args.device)
    audio, rate = audio_io.load_audio(args.input)
    audio = audio_io.preprocess_audio(audio, rate, separator.sample_rate)

    gains = list(args.gains)
    use_keys = args.interactive and sys.stdin.isatty()
    restore_tty = None
    if use_keys:
        import termios
        import tty

        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        restore_tty = lambda: termios.tcsetattr(fd, termios.TCSADRAIN, saved)  # noqa: E731

    out_chunks = []
    t0 = time.time()
    total = audio.shape[-1] / separator.sample_rate
    done = 0.0
    try:
        for remix, levels in stream_demix(separator, audio, gains, args.chunk_seconds):
            out_chunks.append(remix)
            done += remix.shape[-1] / separator.sample_rate
            if args.interactive:
                sys.stdout.write("\x1b[2J\x1b[H")
                print(f"demixing {args.input}  [{done:.1f}/{total:.1f}s]  "
                      f"({done / max(time.time() - t0, 1e-9):.2f}x realtime)")
                print(_render_meters(levels, gains))
                if use_keys:
                    print("keys: b/B v/V o/O d/D gain -/+ 0.1, q stops")
            if use_keys and not _drain_keys(gains):
                print("stopped by user")
                break
    finally:
        if restore_tty is not None:
            restore_tty()

    remix = np.concatenate(out_chunks, axis=-1)[0]
    audio_io.save_audio(args.output, remix, int(separator.sample_rate))
    print(f"wrote {args.output} ({remix.shape[-1] / separator.sample_rate:.1f}s) "
          f"in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    demixui_main()
