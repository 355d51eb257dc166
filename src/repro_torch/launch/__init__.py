"""Launchers.  `serve` runs batched LM decoding through the continuous-batching
engine; `train` trains a language model, on one device or sharded over a
mesh under ``torchrun``; `mesh` builds the device meshes; `dryrun` lays out
and traces a production-size cell on a fake process group."""
