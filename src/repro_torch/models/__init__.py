"""Model bundles of the port (`api.build_bundle`) and the converter of
reference parameters (`convert`)."""
