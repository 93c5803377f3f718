"""Data: dataset readers, the COLMAP and PLY formats, camera loading."""

from gsjax_torch.data.dataset import SceneInfo, load_scene_info, scene_load_type_callbacks
from gsjax_torch.data.ply import load_gaussian_ply, save_gaussian_ply

__all__ = [
    "SceneInfo",
    "load_scene_info",
    "scene_load_type_callbacks",
    "load_gaussian_ply",
    "save_gaussian_ply",
]
