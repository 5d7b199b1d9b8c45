from vs_seg.core.config import Config, parse_cli, add_reference_cli_flags, config_from_args
from vs_seg.core.runlog import set_up_logger, create_results_folders, log_parameters
