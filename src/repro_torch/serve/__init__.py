"""Force-field serving: slot pools and the serve engine."""
