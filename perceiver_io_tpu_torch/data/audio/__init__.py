"""Audio data (host-side numpy): the MIDI event codec and the
symbolic-audio data modules that feed Perceiver AR training. Counterpart of
``perceiver_io_tpu/data/audio``."""
from perceiver_io_tpu_torch.data.audio.midi import (
    PAD_TOKEN,
    SEPARATOR,
    VOCAB_SIZE,
    ControlChange,
    Note,
    decode_to_midi_file,
    encode_midi_file,
    encode_midi_files,
    events_from_notes,
    notes_from_events,
)
from perceiver_io_tpu_torch.data.audio.symbolic import (
    GiantMidiPianoDataModule,
    MaestroV3DataModule,
    SymbolicAudioCollator,
    SymbolicAudioDataModule,
    SyntheticSymbolicAudioDataModule,
    SymbolicAudioDataset,
)

__all__ = [
    "PAD_TOKEN",
    "SEPARATOR",
    "VOCAB_SIZE",
    "Note",
    "ControlChange",
    "events_from_notes",
    "notes_from_events",
    "encode_midi_file",
    "encode_midi_files",
    "decode_to_midi_file",
    "SymbolicAudioCollator",
    "SymbolicAudioDataModule",
    "SyntheticSymbolicAudioDataModule",
    "SymbolicAudioDataset",
    "MaestroV3DataModule",
    "GiantMidiPianoDataModule",
]
