"""Tool pipelines of the port."""
