"""The benchmark's plain reference of Point-NeRF: the grid, the query, the
shading, the ray march, the losses and Adam in plain PyTorch, float32,
independent of the program under test (it imports none of it), and the
row counter that says what work a batch of rays needs."""
