"""The LM training substrate: AdamW, atomic checkpoints with elastic
restore, fault tools and the train step (port of ``src/repro/train``)."""
