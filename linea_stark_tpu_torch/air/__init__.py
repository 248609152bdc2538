"""AIR layer: constraint gadgets over vector and scalar algebras."""
