"""The language models' training steps and checkpoints."""
