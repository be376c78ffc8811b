from perceiver_io_tpu_torch.data.audio.midi import Note, decode_events, encode_notes
from perceiver_io_tpu_torch.data.audio.symbolic import SymbolicAudioDataModule

__all__ = [
    "Note",
    "decode_events",
    "encode_notes",
    "SymbolicAudioDataModule",
]
