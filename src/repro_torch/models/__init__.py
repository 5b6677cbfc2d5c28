"""Dense decoder model of the port (config, blocks, assembly)."""
