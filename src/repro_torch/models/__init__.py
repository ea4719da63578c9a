"""Model bundles of the port (`api.build_bundle`), BERT4Rec (`bert4rec`),
the four GNNs (`gnn_models`) and the converters of reference parameters
(`convert`)."""
