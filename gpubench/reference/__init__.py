"""Plain references, one a configuration, and their shared front end."""
