"""Checkpoints of the port (mirrors ``repro.ckpt``): the reference's
on-disk format for index checkpoints, swept frontiers and training state,
readable and writable by both packages, and the trainer's rotating
:class:`CheckpointManager`."""
from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.ckpt.frontier_io import (frontier_json, load_frontier,
                                          save_frontier)
from repro_torch.ckpt.index_io import (load_index, save_index,
                                        save_index_delta)
from repro_torch.ckpt.versioning import (ArtifactFormatError,
                                         StaleArtifactError,
                                         check_artifact_age,
                                         check_artifact_format)

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "save_index", "load_index",
           "save_index_delta",
           "save_frontier", "load_frontier", "frontier_json",
           "ArtifactFormatError", "check_artifact_format",
           "StaleArtifactError", "check_artifact_age"]
