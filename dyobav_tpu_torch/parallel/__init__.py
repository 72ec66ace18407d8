"""Device lists, batch sharding and the multi-process entry (`mesh`)."""
