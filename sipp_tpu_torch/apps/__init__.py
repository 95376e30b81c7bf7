"""Applications of the port: BLS signature aggregation (bls_aggregation)."""
