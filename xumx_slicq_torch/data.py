"""Training datasets and the batch loader (host side, NumPy).

The port's own copy of what the trainer needs from xumx_slicq_tpu/data.py
(:222-694): the gain and channel-swap augmentations, the MUSDB18-HQ and
Periphery wav-tree datasets (random crops, random track mixing, musdb's
14-track validation split), the synthetic dataset, `pad_collate` and the
loader. The sampling is the same draw for draw: the loader derives every
item's seed from (loader seed, epoch, batch, item), so both packages yield
bit-equal batches from the same data. Wav reads go through the port's
`audio.py`.

Items are (5, C, samples) float32 stacked as (mix, bass, vocals, other,
drums).
"""

import queue
import random
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Optional

import numpy as np
from scipy.io import wavfile

from .audio import _crop_to_float32, load_audio, load_info

SOURCES = ["bass", "vocals", "other", "drums"]

# musdb's canonical validation tracks (musdb.DB split="valid")
MUSDB_VALIDATION_TRACKS = [
    "Actions - One Minute Smile",
    "Clara Berry And Wooldog - Waltz For My Victims",
    "Johnny Lokke - Promises & Lies",
    "Patrick Talbot - A Reason To Leave",
    "Triviul - Angelsaint",
    "Alexander Ross - Goodbye Bolero",
    "Fergessen - Nos Palpitants",
    "Leaf - Summerghost",
    "Skelpolu - Human Mistakes",
    "Young Griffo - Pennies",
    "ANiMAL - Rockshow",
    "James May - On The Line",
    "Meaxic - Take A Step",
    "Traffic Experiment - Sirens",
]


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------


def _augment_gain(audio: np.ndarray, rng: random.Random, low=0.25, high=1.25) -> np.ndarray:
    return audio * (low + rng.random() * (high - low))


def _augment_channelswap(audio: np.ndarray, rng: random.Random) -> np.ndarray:
    if audio.shape[0] == 2 and rng.random() < 0.5:
        return audio[::-1]
    return audio


class AugChain:
    """A chain of augmentations. `canonical_fold` (set by aug_from_str for
    a duplicate-free gain/channelswap chain) lets TrackTreeDataset fold the
    chain into its one load-and-scale pass, with the same random draws."""

    def __init__(self, names: List[str], fns: List[Callable], canonical_fold: bool = False):
        self.names = tuple(names)
        self._fns = fns
        self.canonical_fold = canonical_fold

    def __call__(self, audio, rng):
        for f in self._fns:
            audio = f(audio, rng)
        return audio


def aug_from_str(names: List[str]) -> AugChain:
    fns = {"gain": _augment_gain, "channelswap": _augment_channelswap}
    canonical = set(names) <= set(fns) and len(set(names)) == len(names)
    return AugChain(list(names), [fns[n] for n in names], canonical_fold=canonical)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


class TrackTreeDataset:
    """A wav tree with one directory of stems per track
    (root/<subset>/<track>/{mixture,bass,drums,vocals,other}.wav).

    Training draws `samples_per_track` random excerpts per track per epoch,
    optionally mixing each source from a random track, with augmentations;
    validation yields whole tracks in order (reference data.py:316-390)."""

    sample_rate = 44100.0

    def __init__(
        self,
        root: str,
        split: str = "train",
        subset_dir: Optional[str] = None,
        seq_duration: Optional[float] = 6.0,
        samples_per_track: int = 64,
        source_augmentations: Optional[Callable] = None,
        random_track_mix: bool = False,
        fixed_start: float = -1.0,
        seed: int = 42,
        in_memory: bool = False,
        validation_tracks: Optional[List[str]] = None,
    ):
        self.root = Path(root)
        self.split = split
        self.seq_duration = seq_duration
        self.samples_per_track = samples_per_track
        self.source_augmentations = source_augmentations or (lambda a, rng: a)
        self.random_track_mix = random_track_mix
        self.fixed_start = fixed_start
        self.rng = random.Random(seed)
        self.in_memory = in_memory

        if subset_dir is None:
            # musdb: train and valid both live under "train", split by name
            subset_dir = "test" if split == "test" else "train"
        base = self.root / subset_dir
        if not base.exists():
            base = self.root / split                 # periphery: root/{train,valid}/<track>
        if not base.exists():
            raise FileNotFoundError(f"no dataset directory at {base}")

        if validation_tracks is None:
            validation_tracks = MUSDB_VALIDATION_TRACKS
        names = sorted(d.name for d in base.iterdir() if d.is_dir())
        if (self.root / "train").exists() and subset_dir == "train" and split in ("train", "valid"):
            if split == "valid":
                names = [n for n in names if n in validation_tracks] or names
            else:
                names = [n for n in names if n not in validation_tracks]

        self._stem_cache = {}
        self.tracks = []
        for d in (base / n for n in names):
            info = load_info(d / "mixture.wav")
            entry = {"path": d, "name": d.name, "duration": info["duration"],
                     "samples": info["samples"], "channels": info["channels"]}
            if in_memory:
                entry["audio"] = {s: load_audio(d / f"{s}.wav")[0] for s in ["mixture"] + SOURCES}
            self.tracks.append(entry)
        if self.seq_duration and self.tracks:
            # a fixed item shape lets the loader fill batch rows in place
            self.item_shape = (5, self.tracks[0]["channels"], int(self.seq_duration * self.sample_rate))

    def __len__(self):
        return len(self.tracks) * self.samples_per_track

    def _open_stem(self, track, source):
        """(samplerate, (samples, C) memmap) of one stem, opened once."""
        key = (track["name"], source)
        ent = self._stem_cache.get(key)
        if ent is None:
            sr, data = wavfile.read(str(track["path"] / f"{source}.wav"), mmap=True)
            if data.ndim == 1:
                data = data[:, None]
            ent = (sr, data)
            self._stem_cache[key] = ent
        return ent

    def _read(self, track, source, start_s, dur_s):
        if self.in_memory:
            a = track["audio"][source]
            if dur_s is None:
                return a
            lo = int(start_s * self.sample_rate)
            return a[:, lo: lo + int(dur_s * self.sample_rate)]
        if dur_s is None:
            return load_audio(track["path"] / f"{source}.wav")[0]
        sr, data = self._open_stem(track, source)
        lo = int(start_s * sr)
        return _crop_to_float32(data[lo: lo + int(dur_s * sr)])

    def __getitem__(self, index: int) -> np.ndarray:
        return self._getitem_rng(index, self.rng)

    def getitem_seeded(self, index: int, seed: int) -> np.ndarray:
        """The item drawn from a private RNG seeded by the loader."""
        return self._getitem_rng(index, random.Random(seed))

    def getitem_into(self, out: np.ndarray, index: int, seed: Optional[int] = None):
        """Fill a (5, C, n) float32 batch row in place; seed=None draws from
        the dataset's own RNG."""
        self._fill_item(out, index, self.rng if seed is None else random.Random(seed))

    def _getitem_rng(self, index: int, rng: random.Random) -> np.ndarray:
        if self.seq_duration:
            out = np.empty(self.item_shape, np.float32)
            self._fill_item(out, index, rng)
            return out
        track = self.tracks[index // self.samples_per_track]
        x = self._read(track, "mixture", 0, None)
        ys = {s: self._read(track, s, 0, None) for s in SOURCES}
        return np.stack([x, ys["bass"], ys["vocals"], ys["other"], ys["drums"]]).astype(np.float32)

    def _fill_item(self, out: np.ndarray, index: int, rng: random.Random):
        """Write one training item into out (5, C, n). With the canonical
        gain/channelswap chain, the gain folds into the PCM scale and the
        swap into the transpose, with the chain's own random draws."""
        track = self.tracks[index // self.samples_per_track]
        aug = self.source_augmentations
        foldable = getattr(aug, "canonical_fold", False) and not self.in_memory
        n = out.shape[-1]
        for k, source in enumerate(SOURCES):
            if self.random_track_mix:
                track = rng.choice(self.tracks)
            dur = min(track["duration"], self.seq_duration)
            start = rng.uniform(0, track["duration"] - dur) if self.fixed_start < 0 else self.fixed_start
            if foldable:
                sr, data = self._open_stem(track, source)
                seg = data[int(start * sr): int(start * sr) + int(dur * sr)]
                gain, swap = 1.0, False
                for name in aug.names:                      # the draws of _augment_*
                    if name == "gain":
                        gain = 0.25 + rng.random() * 1.0
                    elif name == "channelswap" and seg.shape[1] == 2:
                        swap = rng.random() < 0.5
                m = min(seg.shape[0], n)
                seg = seg[:m, ::-1] if swap else seg[:m]
                _crop_to_float32(seg, gain=gain, out=out[1 + k, :, :m])
                if m < n:
                    out[1 + k, :, m:] = 0.0
                continue
            audio = aug(self._read(track, source, start, dur), rng)
            m = min(audio.shape[-1], n)
            out[1 + k, :, :m] = audio[:, :m]
            if m < n:
                out[1 + k, :, m:] = 0.0
        np.sum(out[1:], axis=0, out=out[0])


class MUSDBDataset(TrackTreeDataset):
    """MUSDB18-HQ (reference data.py:211-403)."""

    @staticmethod
    def load_datasets(seed: int, train_seq_dur: float, samples_per_track: int = 64, musdb_root: str = "/MUSDB18-HQ"):
        train = MUSDBDataset(
            root=musdb_root, split="train", seq_duration=train_seq_dur,
            samples_per_track=samples_per_track, source_augmentations=aug_from_str(["gain", "channelswap"]),
            random_track_mix=True, seed=seed,
        )
        valid = MUSDBDataset(root=musdb_root, split="valid", seq_duration=None, samples_per_track=1, seed=seed)
        return train, valid


class PeripheryDataset(TrackTreeDataset):
    """The Periphery wav tree, held in memory (reference data.py:406-586)."""

    def __init__(self, *args, **kw):
        kw.setdefault("in_memory", True)
        super().__init__(*args, **kw)

    @staticmethod
    def load_datasets(seed: int, train_seq_dur: float, samples_per_track: int = 64, periphery_root: str = "/Periphery"):
        train = PeripheryDataset(
            root=periphery_root, split="train", subset_dir="train",
            seq_duration=train_seq_dur, samples_per_track=samples_per_track,
            source_augmentations=aug_from_str(["gain", "channelswap"]), random_track_mix=True, seed=seed,
        )
        valid = PeripheryDataset(root=periphery_root, split="valid", subset_dir="valid",
                                 seq_duration=None, samples_per_track=1, seed=seed)
        return train, valid


class SyntheticDataset:
    """Deterministic synthetic stems for tests and smoke runs: each track
    sums four band-limited tonal-plus-noise sources in different spectral
    regions, enough structure for training to lower the loss."""

    sample_rate = 44100.0

    def __init__(self, n_tracks=4, seq_duration=2.0, samples_per_track=4, seed=0, track_duration=8.0):
        self.n_tracks = n_tracks
        self.seq_duration = seq_duration
        self.samples_per_track = samples_per_track
        self.track_duration = track_duration
        rng = np.random.default_rng(seed)
        n = int(track_duration * self.sample_rate)
        t = np.arange(n) / self.sample_rate
        self._tracks = []
        bands = [(41.0, 120.0), (220.0, 880.0), (1000.0, 3000.0), (80.0, 8000.0)]
        for _ in range(n_tracks):
            stems = []
            for (lo, hi) in bands:
                f0 = rng.uniform(lo, hi)
                sig = np.stack([
                    0.2 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28)) + 0.05 * rng.standard_normal(n)
                    for _ in range(2)
                ])
                env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.1, 2.0) * t))
                stems.append((sig * env).astype(np.float32))
            self._tracks.append(np.stack(stems))  # (4, 2, n)
        self.rng = random.Random(seed)

    def __len__(self):
        return self.n_tracks * self.samples_per_track

    def __getitem__(self, index):
        return self._getitem_rng(index, self.rng)

    def getitem_seeded(self, index, seed):
        return self._getitem_rng(index, random.Random(seed))

    def _getitem_rng(self, index, rng):
        stems = self._tracks[index // self.samples_per_track]
        if self.seq_duration:
            n = int(self.seq_duration * self.sample_rate)
            lo = rng.randrange(0, max(stems.shape[-1] - n, 1))   # no slack -> start 0
            stems = stems[..., lo: lo + n]
        x = stems.sum(0)
        return np.concatenate([x[None], stems]).astype(np.float32)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------


def pad_collate(items: List[np.ndarray]) -> np.ndarray:
    """Zero-pad items to a common length (reference data.py:14-36)."""
    max_len = max(it.shape[-1] for it in items)
    if all(it.shape[-1] == max_len for it in items):
        return np.stack(items).astype(np.float32, copy=False)
    out = np.zeros((len(items), *items[0].shape[:-1], max_len), np.float32)
    for i, it in enumerate(items):
        out[i, ..., : it.shape[-1]] = it
    return out


class DataLoader:
    """Shuffling, batching and background prefetch on host threads.

    For datasets with `getitem_seeded`/`getitem_into`, each item's seed is
    derived from (loader seed, epoch, batch index, item index), so the data
    is the same for any `workers` count, any prefetch depth, and whether or
    not an earlier epoch ran to its end. workers > 0 loads a batch's items
    on a thread pool (numpy and mmap reads release the GIL)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = workers
        self._epoch = 0
        self._seeded = hasattr(dataset, "getitem_seeded")
        self._pool = None
        if workers > 0 and self._seeded:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _item_seed(self, epoch: int, bi: int, ii: int) -> int:
        # field packing, unique per position
        return (((self.seed & 0xFFFFFFFF) << 96) | ((epoch & 0xFFFFFFFF) << 64)
                | ((bi & 0xFFFFFFFF) << 32) | (ii & 0xFFFFFFFF))

    def _load_items(self, sel, epoch: int, bi: int) -> List[np.ndarray]:
        if not self._seeded:
            return [self.dataset[int(j)] for j in sel]
        geti = self.dataset.getitem_seeded
        if self._pool is not None:
            futs = [self._pool.submit(geti, int(j), self._item_seed(epoch, bi, ii)) for ii, j in enumerate(sel)]
            return [f.result() for f in futs]
        return [geti(int(j), self._item_seed(epoch, bi, ii)) for ii, j in enumerate(sel)]

    def _batches(self) -> Iterator[np.ndarray]:
        epoch = self._epoch
        self._epoch += 1
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        shape = getattr(self.dataset, "item_shape", None)
        into = getattr(self.dataset, "getitem_into", None)
        for bi, i in enumerate(range(0, len(idx), self.batch_size)):
            sel = idx[i: i + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                return
            if shape is None or into is None:
                yield pad_collate(self._load_items(sel, epoch, bi))
                continue
            batch = np.empty((len(sel), *shape), np.float32)     # rows filled in place
            if self._pool is not None:
                futs = [self._pool.submit(into, batch[ii], int(j), self._item_seed(epoch, bi, ii))
                        for ii, j in enumerate(sel)]
                for f in futs:
                    f.result()
            else:
                for ii, j in enumerate(sel):
                    into(batch[ii], int(j), self._item_seed(epoch, bi, ii))
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            finally:
                put(sentinel)           # bounded and stop-aware, so a full queue cannot lose it

        th = threading.Thread(target=worker, daemon=True, name="slicq-prefetch")
        th.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    break
                yield b
        finally:
            # abandoned mid-epoch: unblock the producer and drop its batches
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            th.join(timeout=5.0)
