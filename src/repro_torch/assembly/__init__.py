"""FEM assembly subsystem: conflict-free construction of the global CSRC
matrices the SpMV stack consumes.

  mesh       structured tri/quad/tet meshes + deterministic (dyadic)
             element stiffness synthesis
  conflict   element conflict graph + balanced coloring (reuses
             core/coloring machinery)
  scatter    accumulation strategies (colored kernels K13/K14 / sorted-slot
             / private-buffer / serial oracle) + the cached
             AssemblySchedule artifact + tune_assembly strategy selection
             (kernels live in repro_torch.kernels.assembly_scatter)

End to end:  mesh → stiffness → assemble → tune → serve / solve, on the
card by default (``device=``).
"""
from .mesh import (Mesh, grid_quad, grid_tet, grid_tri,          # noqa: F401
                   poisson_stiffness, synthetic_stiffness)
from .conflict import (color_elements, element_dofs,             # noqa: F401
                       verify_element_coloring)
from .scatter import (AssemblySchedule, AssemblyTuneResult,      # noqa: F401
                      assemble, assemble_mesh,
                      assembly_schedule_for, build_assembly_schedule,
                      scatter_colored, scatter_colored_percolor,
                      scatter_private, scatter_serial, scatter_sorted,
                      structure_digest, tune_assembly, values_to_csrc)
