"""Training: the synthetic speech corpus (synth), its recording-chain
augmentation (augment) and the VAD / diarization nets' trainers
(diarize_train)."""
