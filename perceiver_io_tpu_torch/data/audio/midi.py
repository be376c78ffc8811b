"""MIDI event codec: notes <-> event-token sequences (a numpy copy of
``perceiver_io_tpu/data/audio/midi.py``).

Behavioral parity with the reference codec
(reference: perceiver/data/audio/midi_processor.py:13-270), which follows the
Music-Transformer event grammar: 128 note_on + 128 note_off + 100 time_shift
(10ms steps, 10ms..1000ms) + 32 velocity bins = 388 event ids; PAD 388,
vocab 389.

Implemented natively over a plain ``Note`` record so tokenization needs no
external MIDI library; ``encode_midi_file``/``decode_to_midi_file`` gate the
optional ``pretty_midi`` dependency for actual .mid I/O.
"""

from __future__ import annotations

from dataclasses import dataclass
from multiprocessing import Pool
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_TIME_SHIFT = 100
RANGE_VEL = 32

START_IDX = {
    "note_on": 0,
    "note_off": RANGE_NOTE_ON,
    "time_shift": RANGE_NOTE_ON + RANGE_NOTE_OFF,
    "velocity": RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_TIME_SHIFT,
}

VOCAB_SIZE = RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_TIME_SHIFT + RANGE_VEL + 1  # + PAD
PAD_ID = VOCAB_SIZE - 1  # 388


@dataclass
class Note:
    velocity: int
    pitch: int
    start: float
    end: float


@dataclass
class _SplitNote:
    type: str  # note_on | note_off
    time: float
    value: int
    velocity: Optional[int]


@dataclass
class _Sustain:
    start: float
    end: Optional[float]


def _apply_sustain(sustains: List[_Sustain], notes: List[Note]) -> List[Note]:
    """Extend note ends through sustain-pedal intervals
    (reference: midi_processor.py SustainDownManager + _note_preprocess)."""
    note_stream: List[Note] = []
    managed_per_sustain: List[List[Note]] = []

    for sustain in sustains:
        managed: List[Note] = []
        remaining = []
        consumed = False
        for note_idx, note in enumerate(notes):
            if note.start < sustain.start:
                note_stream.append(note)
            elif note.start > sustain.end:
                remaining = notes[note_idx:]
                consumed = True
                break
            else:
                managed.append(note)
        if consumed:
            notes = remaining
        else:
            notes = []
        # transposition: each managed note's end extends to the next same-pitch
        # start, else at least to the sustain end
        note_dict = {}
        for note in reversed(managed):
            if note.pitch in note_dict:
                note.end = note_dict[note.pitch]
            else:
                note.end = max(sustain.end, note.end)
            note_dict[note.pitch] = note.start
        managed_per_sustain.append(managed)

    for managed in managed_per_sustain:
        note_stream += managed
    note_stream += notes
    note_stream.sort(key=lambda n: n.start)
    return note_stream


def sustains_from_control_changes(times_values) -> List[_Sustain]:
    """(time, value) pairs of CC64 events -> sustain-down intervals
    (reference: midi_processor.py:_control_preprocess)."""
    sustains: List[_Sustain] = []
    manager = None
    for time, value in times_values:
        if value >= 64 and manager is None:
            manager = _Sustain(start=time, end=None)
        elif value < 64 and manager is not None:
            manager.end = time
            sustains.append(manager)
            manager = None
        elif value < 64 and sustains:
            sustains[-1].end = time
    return sustains


def _time_shift_events(prev_time: float, post_time: float) -> List[int]:
    interval = int(round((post_time - prev_time) * 100))
    events = []
    while interval >= RANGE_TIME_SHIFT:
        events.append(START_IDX["time_shift"] + RANGE_TIME_SHIFT - 1)
        interval -= RANGE_TIME_SHIFT
    if interval > 0:
        events.append(START_IDX["time_shift"] + interval - 1)
    return events


def encode_notes(
    notes: Sequence[Note], sustains: Optional[List[_Sustain]] = None
) -> List[int]:
    """Notes -> event token ids (reference: midi_processor.py:encode_midi)."""
    notes = [Note(n.velocity, n.pitch, n.start, n.end) for n in notes]
    if sustains:
        notes = _apply_sustain(sustains, notes)

    notes.sort(key=lambda n: n.start)
    split: List[_SplitNote] = []
    for n in notes:
        split.append(_SplitNote("note_on", n.start, n.pitch, n.velocity))
        split.append(_SplitNote("note_off", n.end, n.pitch, None))
    split.sort(key=lambda s: s.time)

    events: List[int] = []
    cur_time = 0.0
    cur_vel = 0
    for snote in split:
        events += _time_shift_events(cur_time, snote.time)
        if snote.velocity is not None:
            vel_bin = snote.velocity // 4
            if cur_vel != vel_bin:
                events.append(START_IDX["velocity"] + vel_bin)
            cur_vel = vel_bin
        events.append(START_IDX[snote.type] + snote.value)
        cur_time = snote.time
        # NOTE: matches the reference, which tracks raw velocity of note_on
        # and None for note_off separately from the emitted bin
    return events


def decode_events(ids: Sequence[int]) -> List[Note]:
    """Event token ids -> notes (reference: midi_processor.py:decode_midi)."""
    timeline = 0.0
    velocity = 0
    note_on: dict = {}
    notes: List[Note] = []
    for i in ids:
        i = int(i)
        if i < 0 or i >= VOCAB_SIZE - 1:
            continue  # separator / PAD
        if START_IDX["time_shift"] <= i < START_IDX["velocity"]:
            timeline += (i - START_IDX["time_shift"] + 1) / 100
        elif i >= START_IDX["velocity"]:
            velocity = (i - START_IDX["velocity"]) * 4
        elif i < RANGE_NOTE_ON:
            note_on[i] = (timeline, velocity)
        else:
            pitch = i - RANGE_NOTE_ON
            if pitch in note_on:
                start, vel = note_on.pop(pitch)
                if timeline - start > 0:
                    notes.append(Note(velocity=vel, pitch=pitch, start=start, end=timeline))
    notes.sort(key=lambda n: n.start)
    return notes


# ------------------------------------------------------------- .mid file I/O


def encode_midi_file(path: Path) -> Optional[np.ndarray]:
    """Requires pretty_midi (optional)."""
    try:
        import pretty_midi
    except ImportError as e:
        raise ImportError("pretty_midi is required for .mid file I/O") from e
    try:
        midi = pretty_midi.PrettyMIDI(str(path))
    except Exception as e:  # malformed files are skipped, like the reference
        print(f"Error encoding midi file [{path}]: {e}")
        return None

    notes: List[Note] = []
    for inst in midi.instruments:
        inst_notes = [Note(n.velocity, n.pitch, n.start, n.end) for n in inst.notes]
        ctrls = [(c.time, c.value) for c in inst.control_changes if c.number == 64]
        sustains = sustains_from_control_changes(ctrls)
        if sustains:
            inst_notes = _apply_sustain(sustains, inst_notes)
        notes += inst_notes
    return np.asarray(encode_notes(notes), dtype=np.int16)


def decode_to_midi_file(ids: Sequence[int], path: Optional[Path] = None):
    try:
        import pretty_midi
    except ImportError as e:
        raise ImportError("pretty_midi is required for .mid file I/O") from e
    notes = decode_events(ids)
    mid = pretty_midi.PrettyMIDI()
    instrument = pretty_midi.Instrument(1, False, "perceiver_io_tpu_torch")
    instrument.notes = [pretty_midi.Note(n.velocity, n.pitch, n.start, n.end) for n in notes]
    mid.instruments.append(instrument)
    if path is not None:
        mid.write(str(path))
    return mid


def encode_midi_files(files: List[Path], num_workers: int = 1) -> List[np.ndarray]:
    """(reference: midi_processor.py:encode_midi_files)"""
    if num_workers <= 1:
        results = [encode_midi_file(f) for f in files]
    else:
        with Pool(processes=num_workers) as pool:
            results = list(pool.imap(encode_midi_file, files))
    return [r for r in results if r is not None]
