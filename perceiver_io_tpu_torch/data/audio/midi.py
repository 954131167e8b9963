"""MIDI event codec: the symbolic-audio token vocabulary. Counterpart of
``perceiver_io_tpu/data/audio/midi.py`` (a copy: the port imports nothing of
the JAX package), itself after the upstream project's MIDI processor.

388 events:

- ``note_on``    pitch 0-127   -> ids   0-127
- ``note_off``   pitch 0-127   -> ids 128-255
- ``time_shift`` 10ms-1s steps -> ids 256-355 (value ``v`` = (v+1)/100 s)
- ``velocity``   32 buckets    -> ids 356-387 (bucket = velocity // 4)

plus PAD=388 (vocab size 389). Encoding emits a velocity event only when the
bucket changes; time gaps > 1s emit repeated max shifts. Sustain-pedal
(CC 64) handling extends note-offs to the pedal release or the next
same-pitch note-on.

The codec works on a neutral :class:`Note` representation, so it runs
without a MIDI I/O library; :func:`encode_midi_file` /
:func:`decode_to_midi_file` bridge to ``pretty_midi``, imported when called,
and raise ``ImportError`` without it.
"""
from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_TIME_SHIFT = 100
RANGE_VELOCITY = 32

NOTE_ON_OFFSET = 0
NOTE_OFF_OFFSET = RANGE_NOTE_ON
TIME_SHIFT_OFFSET = RANGE_NOTE_ON + RANGE_NOTE_OFF
VELOCITY_OFFSET = RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_TIME_SHIFT

NUM_EVENTS = VELOCITY_OFFSET + RANGE_VELOCITY  # 388
PAD_TOKEN = NUM_EVENTS  # 388
VOCAB_SIZE = NUM_EVENTS + 1  # 389
SEPARATOR = -1  # example separator in flat storage (reference symbolic.py:17)

TIME_STEP = 0.01  # seconds per time_shift unit


@dataclass
class Note:
    """One played note; the neutral exchange type of the codec."""

    pitch: int
    velocity: int
    start: float
    end: float


@dataclass
class ControlChange:
    """A control-change message; only CC 64 (sustain) is interpreted."""

    number: int
    value: int
    time: float


def _apply_sustain(notes: List[Note], controls: Sequence[ControlChange]) -> List[Note]:
    """Extend notes held by the sustain pedal (CC64 ≥ 64 down, < 64 up):
    within a pedal window a note's end is moved to the next start of the same
    pitch, or to the pedal release if no such note follows (reference
    ``midi_processor.py:31-47,172-208``)."""
    pedals: List[Tuple[float, float]] = []
    down: Optional[float] = None
    for ctrl in sorted((c for c in controls if c.number == 64), key=lambda c: c.time):
        if ctrl.value >= 64 and down is None:
            down = ctrl.time
        elif ctrl.value < 64 and down is not None:
            pedals.append((down, ctrl.time))
            down = None
        elif ctrl.value < 64 and pedals:
            pedals[-1] = (pedals[-1][0], ctrl.time)
    if not pedals:
        return notes

    notes = sorted((Note(n.pitch, n.velocity, n.start, n.end) for n in notes),
                   key=lambda n: n.start)
    for start, end in pedals:
        managed = [n for n in notes if start <= n.start <= end]
        # Walk backwards: each managed note ends at the next same-pitch start,
        # the last one at max(pedal end, its own end).
        next_start: dict = {}
        for note in reversed(managed):
            if note.pitch in next_start:
                note.end = next_start[note.pitch]
            else:
                note.end = max(end, note.end)
            next_start[note.pitch] = note.start
    return notes


def events_from_notes(
    notes: Iterable[Note],
    controls: Sequence[ControlChange] = (),
) -> List[int]:
    """Notes (+ sustain controls) → event-id sequence."""
    notes = _apply_sustain(list(notes), controls)

    # Split into timed on/off markers, stable-ordered by time.
    markers: List[Tuple[float, str, Note]] = []
    for note in sorted(notes, key=lambda n: n.start):
        markers.append((note.start, "note_on", note))
        markers.append((note.end, "note_off", note))
    markers.sort(key=lambda m: m[0])

    events: List[int] = []
    cur_time = 0.0
    cur_vel_bucket = 0
    for time, kind, note in markers:
        # time shifts (repeat max shift for gaps > 1s)
        interval = int(round((time - cur_time) / TIME_STEP))
        while interval >= RANGE_TIME_SHIFT:
            events.append(TIME_SHIFT_OFFSET + RANGE_TIME_SHIFT - 1)
            interval -= RANGE_TIME_SHIFT
        if interval > 0:
            events.append(TIME_SHIFT_OFFSET + interval - 1)

        if kind == "note_on":
            bucket = note.velocity // 4
            if bucket != cur_vel_bucket:
                events.append(VELOCITY_OFFSET + bucket)
                cur_vel_bucket = bucket
            events.append(NOTE_ON_OFFSET + note.pitch)
        else:
            events.append(NOTE_OFF_OFFSET + note.pitch)
        cur_time = time
    return events


def notes_from_events(event_ids: Iterable[int]) -> List[Note]:
    """Event-id sequence → notes. Unmatched note-offs are dropped,
    zero-length notes discarded (reference ``_merge_note``)."""
    timeline = 0.0
    velocity = 0
    open_notes: dict = {}
    notes: List[Note] = []
    for idx in event_ids:
        idx = int(idx)
        if idx < 0 or idx >= NUM_EVENTS:
            continue  # pad / separator / out-of-vocab
        if idx < NOTE_OFF_OFFSET:
            open_notes[idx] = (timeline, velocity)
        elif idx < TIME_SHIFT_OFFSET:
            pitch = idx - NOTE_OFF_OFFSET
            if pitch in open_notes:
                start, vel = open_notes.pop(pitch)
                if timeline > start:
                    notes.append(Note(pitch, vel, start, timeline))
        elif idx < VELOCITY_OFFSET:
            timeline += (idx - TIME_SHIFT_OFFSET + 1) * TIME_STEP
        else:
            velocity = (idx - VELOCITY_OFFSET) * 4
    notes.sort(key=lambda n: n.start)
    return notes


# -- pretty_midi bridge (optional dependency) ------------------------------
def encode_midi_file(path: Path) -> Optional[np.ndarray]:
    """MIDI file → int16 event array, or None on parse failure."""
    try:
        import pretty_midi
    except ImportError as e:
        raise ImportError("encode_midi_file requires pretty_midi") from e
    try:
        midi = pretty_midi.PrettyMIDI(str(path))
        notes: List[Note] = []
        controls: List[ControlChange] = []
        for inst in midi.instruments:
            sub_controls = [
                ControlChange(c.number, c.value, c.time)
                for c in inst.control_changes
                if c.number == 64
            ]
            sub_notes = [Note(n.pitch, n.velocity, n.start, n.end) for n in inst.notes]
            # Sustain is per-instrument in the reference; encode respecting that.
            notes.extend(_apply_sustain(sub_notes, sub_controls))
        return np.asarray(events_from_notes(notes), np.int16)
    except Exception as e:  # unreadable/corrupt files are skipped, as in reference
        print(f"error encoding midi file [{path}]: {e}")
        return None


def decode_to_midi_file(event_ids: Iterable[int], path: Optional[Path] = None):
    """Event ids → pretty_midi object (optionally written to ``path``)."""
    try:
        import pretty_midi
    except ImportError as e:
        raise ImportError("decode_to_midi_file requires pretty_midi") from e
    midi = pretty_midi.PrettyMIDI()
    instrument = pretty_midi.Instrument(1)
    for note in notes_from_events(event_ids):
        instrument.notes.append(
            pretty_midi.Note(note.velocity, note.pitch, note.start, note.end)
        )
    midi.instruments.append(instrument)
    if path is not None:
        midi.write(str(path))
    return midi


def encode_midi_files(files: Sequence[Path], num_workers: int = 1) -> List[np.ndarray]:
    """Encode files in a process pool (reference ``midi_processor.py:258-263``)."""
    if num_workers <= 1:
        encoded = [encode_midi_file(f) for f in files]
    else:
        with cf.ProcessPoolExecutor(max_workers=num_workers) as pool:
            encoded = list(pool.map(encode_midi_file, files))
    return [e for e in encoded if e is not None]
