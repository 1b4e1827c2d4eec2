"""Token sampling of the port."""
