"""Scene tables, builder, camera, film, materials and lights."""
