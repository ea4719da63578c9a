"""Work partitioning for the port's sharded enumeration (`sharding`) and
sequence-sharded decode attention over the lanes of a mesh
(`context_parallel`)."""
