"""The entries a cell drives, one module each (configs' "entry")."""
