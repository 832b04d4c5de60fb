import logging

from .yaml_out import render_yaml, write_yaml  # noqa: F401

_log = logging.getLogger("gorder")


def write_all_results(results) -> None:
    """Write every requested output (src/presentation/mod.rs:160-241 order:
    YAML → TAB → XVG → CSV → convergence → ordermaps → exports)."""
    analysis = results.analysis
    if analysis is None:
        return
    if not results.molecules:
        # nothing analyzable: the reference writes no output files at all
        # (tests_cg.rs test_cg_order_no_molecules)
        _log.warning("no results to write")
        return
    if analysis.output_yaml:
        write_yaml(results, analysis.output_yaml)
        _log.info("written results to '%s'", analysis.output_yaml)
    if analysis.output_tab:
        from .tab_out import write_tab

        write_tab(results, analysis.output_tab)
    if analysis.output_xvg:
        from .xvg_out import write_xvg

        write_xvg(results, analysis.output_xvg)
    if analysis.output_csv:
        from .csv_out import write_csv

        write_csv(results, analysis.output_csv)
    if (analysis.estimate_error is not None
            and analysis.estimate_error.output_convergence):
        from .convergence_out import write_convergence

        write_convergence(results, analysis.estimate_error.output_convergence)
    if (analysis.map is not None and analysis.map.output_directory
            and results.map_params is not None):
        from .ordermaps_out import write_ordermaps

        write_ordermaps(results, analysis.map.output_directory)
    if (analysis.leaflets is not None and analysis.leaflets.collect.enabled
            and analysis.leaflets.collect.path
            and results.leaflets_data is not None):
        from .leaflets_out import write_leaflets

        write_leaflets(results, analysis.leaflets.collect.path)
    if (analysis.membrane_normal.collect.enabled
            and analysis.membrane_normal.collect.path
            and results.normals_data is not None):
        from .normals_out import write_normals

        write_normals(results, analysis.membrane_normal.collect.path)
