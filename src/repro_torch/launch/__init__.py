"""Launchers.  `serve` runs batched LM decoding through the continuous-batching
engine; `train` trains a language model on one device.  The reference's
dry-run and mesh launchers, and its sharded training, come with
distribution (ROADMAP Queue 1 item 10)."""
