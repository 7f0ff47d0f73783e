"""Default configuration tree of the PyTorch port.

An own copy of the JAX package's defaults (the port imports nothing from
it), key-compatible with the reference's YACS schema so the experiment
YAMLs (e.g. configs/mp3d_gaussian_FR_eccv.yaml) merge cleanly.  The
`tpu` block keeps its name and keys: they are the YAML's, and the port
reads the same tile sizes, capacities and Fisher settings from it.
"""
from .node import ConfigNode


def get_cfg_defaults() -> ConfigNode:
    cfg = ConfigNode()

    cfg.workdir = "experiments/Habitat"
    cfg.run_name = "debug"
    cfg.turn_angle = 10.0
    cfg.forward_step_size = 0.15
    cfg.img_height = 256
    cfg.img_width = 256
    cfg.H_reg_lambda = 0.1
    cfg.H_point_weight = 0.5
    cfg.H_pose_weight = 0.5
    cfg.path_pose_weight = 0.2
    cfg.path_point_weight = 1.0
    cfg.path_end_weight = 1.0
    cfg.object_path_end_weight = 1.0
    cfg.acc_H_train_every = 5
    cfg.num_uniform_H_train = -1
    cfg.opacity_pixel_weight = 0.00001
    cfg.vol_weighted_H = False
    cfg.criterion = "fisher"  # fisher | topt | dopt

    cfg.policy = ConfigNode(dict(
        name="oracle",
        with_rrt_planning=False,
        fbe=False,
        exploration=True,
        save_nav_images=False,
        workdir=cfg.workdir,
        run_name=cfg.run_name,
        steps_after_plan=20,
        occupancy_height_thresh=-1.0,
        planning_queue_size=40,
        action_seq_file="",
        height_upper=1.3,
        height_lower=0.1,
        pcd_far_distance=7.0,
        ensemble_dir="",
    ))

    cfg.planning_queue_size = 40
    cfg.num_frames = 800
    cfg.checkpoint_interval = 40
    cfg.keyframe_every = 4
    cfg.keyframe_obj_every = 2
    cfg.map_every = 10
    cfg.map_obj_every = 2
    cfg.downsample_pcd = 1
    cfg.mapping_window_size = 32

    cfg.report_global_progress_every = 10
    cfg.report_iter_progress = False
    cfg.eval_every = -1
    cfg.save_checkpoints = True
    cfg.scene_radius_depth_ratio = 3
    cfg.use_wandb = False
    cfg.mean_sq_dist_method = "projective"
    cfg.isotropic = False

    cfg.mapping = ConfigNode(dict(
        add_new_gaussians=True,
        add_rand_gaussians=True,
        visualize_frame=0,
        densify_dict=dict(
            final_removal_opacity_threshold=0.005,
            removal_opacity_threshold=0.005,
            densify_every=100,
            grad_thresh=0.0002,
            num_to_split_into=2,
            remove_big_after=3000,
            reset_opacities_every=3000,
            start_after=500,
            stop_after=5000,
            depth_error_ratio=5,
            add_random_gaussians=True,
        ),
        ignore_outlier_depth_loss=False,
        loss_weights=dict(depth=1.0, im=0.5),
        lrs=dict(
            cam_trans=0.0,
            cam_unnorm_rots=0.0,
            log_scales=0.01,
            logit_opacities=0.05,
            means3D=0.001,
            rgb_colors=0.0025,
            unnorm_rotations=0.001,
        ),
        num_iters=60,
        prune_gaussians=False,
        pruning_dict=dict(
            final_removal_opacity_threshold=0.005,
            removal_opacity_threshold=0.005,
            prune_every=20,
            remove_big_after=0,
            reset_opacities=False,
            reset_opacities_every=500,
            start_after=0,
            stop_after=800,
        ),
        sil_thres=0.5,
        use_gaussian_splatting_densification=False,
        use_l1=True,
        use_sil_for_loss=False,
    ))

    cfg.tracking = ConfigNode(dict(
        depth_loss_thres=20000,
        forward_prop=True,
        ignore_outlier_depth_loss=False,
        loss_weights=dict(depth=1.0, im=0.5),
        lrs=dict(
            cam_trans=0.002,
            cam_unnorm_rots=0.0004,
            log_scales=0.0,
            logit_opacities=0.0,
            means3D=0.0,
            rgb_colors=0.0,
            unnorm_rotations=0.0,
        ),
        num_iters=40,
        sil_thres=0.89,
        use_depth_loss_thres=True,
        use_gt_poses=True,
        with_droid=False,
        use_l1=True,
        use_sil_for_loss=True,
        visualize_tracking_loss=False,
    ))

    cfg.explore = ConfigNode(dict(
        height_range=0.6,
        prune_invisible=False,
        sample_view_num=120,
        sample_range=2.0,
        min_range=0.2,
        cell_size=0.1,
        use_frontier=False,
        add_random_gaussians=False,
        grid_candidates=8,
        grid_multipler=3,
        centering=True,
        shortcut_path=True,
        planner_backend="sweep",
        clearance_m=-1.0,
        frontier_select_method="largest",
    ))

    cfg.explore_object = ConfigNode(dict(
        sample_range=3.0,
        min_range=1.0,
        sample_view_num=64,
    ))

    cfg.SLAM = ConfigNode()
    cfg.SLAM.Results = ConfigNode(dict(
        save_results=False,
        save_dir="experiments/GaussianSLAM",
        save_trj=False,
        save_trj_kf_intv=5,
        use_gui=False,
        eval_rendering=False,
        use_wandb=False,
    ))
    cfg.SLAM.Dataset = ConfigNode(dict(
        type="habitat",
        sensor_type="depth",
        pcd_downsample=128,
        pcd_downsample_init=32,
        adaptive_pointsize=True,
        point_size=0.01,
        Calibration=dict(
            fx=128, fy=128, cx=128, cy=128,
            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
            distorted=False, width=256, height=256, depth_scale=1.0,
        ),
    ))
    cfg.SLAM.Training = ConfigNode(dict(use_gt_pose=True, spherical_harmonics=False))
    cfg.SLAM.opt_params = ConfigNode(dict(lambda_dssim=0.2))
    cfg.SLAM.model_params = ConfigNode(dict(sh_degree=0, white_background=False))
    cfg.SLAM.pipeline_params = ConfigNode(dict(convert_SHs_python=False, compute_cov3D_python=False))

    # Settings with no reference analog.  The block keeps the JAX
    # package's name so the same YAML drives both packages; the port has
    # no engine knobs (it picks the kernel by the tensors' device) and
    # reads only the sizes below.
    cfg.tpu = ConfigNode(dict(
        tile_size=16,              # rasterizer tile edge in pixels
        max_per_tile=256,          # initial per-tile Gaussian capacity K;
                                   # doubles up to max_per_tile_limit when
                                   # truncation exceeds overflow_bump_ratio
        max_per_tile_limit=512,
        overflow_bump_ratio=1e-3,
        fisher_tile_size=32,       # tile edge of the Fisher/EIG renders
        fisher_max_per_tile=512,   # per-tile K of the Fisher/EIG renders
        capacity=32768,            # initial Gaussian-state slot capacity
        capacity_growth=2,         # grow factor when slots run out
        blend_chunk=256,           # depth-chunk size of the blend walk
                                   # (clamped to max_per_tile)
        pose_chunk=32,             # candidate poses per Fisher launch
        object_pose_chunk=8,
        pipeline_planning=False,
        plan_watermark=2,
        mapping_frames_per_iter=1,
        fisher_downsample=2,       # EIG renders at (H/s, W/s); grad_value
                                   # and camera.dilation are scaled to
                                   # compensate
        fisher_mode="sq_chain",
        fisher_engine="auto",      # read by the JAX package only
        blend_backward="auto",     # read by the JAX package only
        blend_forward="pallas",    # read by the JAX package only
        hutchinson_probes=8,
        object_h_train_window=64,
        h_train_window=96,         # H_train keyframe budget per planning
                                   # event (strided subsample scaled by
                                   # K/W; 0 = exact full sum)
        mesh_axes=dict(data=1, model=1),
        near=0.01,
        far=100.0,
        max_depth=15.0,            # median-depth fallback
    ))

    return cfg
