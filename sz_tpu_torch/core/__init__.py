"""Host stages of the regression codec: block geometry, the interval
optimizer, the coefficient chain and the body layout."""
