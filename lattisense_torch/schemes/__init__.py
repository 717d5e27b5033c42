"""BFV scheme: data carriers, key generation, key switching, engine, encoding."""
