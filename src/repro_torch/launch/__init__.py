"""Launchers.  `serve` runs batched LM decoding through the continuous-batching
engine; the reference's dry-run, mesh and training launchers come with
distribution (ROADMAP Queue 1 item 10)."""
