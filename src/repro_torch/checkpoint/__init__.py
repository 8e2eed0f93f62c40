from .store import latest_step, load_checkpoint, save_checkpoint, save_from_mesh

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "save_from_mesh"]
