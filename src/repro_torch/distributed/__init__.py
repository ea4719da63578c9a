"""Work partitioning for the port's sharded enumeration (`sharding`)."""
