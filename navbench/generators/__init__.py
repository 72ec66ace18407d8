"""Traffic generators: each reads the parameters of a `traffic/*.json` mix."""
