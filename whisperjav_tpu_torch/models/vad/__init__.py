"""Frame VAD networks: Silero v5/v6, the silero-class GRU model, TEN and
WhisperSeg (counterparts of ``whisperjav_tpu/models/vad/``)."""
