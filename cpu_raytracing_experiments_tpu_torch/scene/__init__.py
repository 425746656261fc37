"""Scene model and builders."""
