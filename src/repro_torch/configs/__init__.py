"""Architecture configs of the port (`registry.get_config`)."""
