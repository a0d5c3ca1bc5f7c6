"""The benchmark's plain reference: plain PyTorch and numpy, importing
nothing of the program (``voxelrt_torch``) and nothing of JAX or the JAX
package. Most modules are frozen copies of the port's plain code, taken
when the benchmark was defined, so that a later change to the program
cannot move the yardstick; ``scene.py`` records the example script's scene
and ``render.py`` replays a still's samples for chosen pixels."""
