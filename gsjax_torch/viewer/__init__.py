"""The SIBR remote viewer's server (gsjax_torch.viewer.network_gui)."""

from gsjax_torch.viewer.network_gui import NetworkGUI, ViewerRequest

__all__ = ["NetworkGUI", "ViewerRequest"]
