"""Meshes (logical and process-group), shard_map, collectives and the
pipeline."""
